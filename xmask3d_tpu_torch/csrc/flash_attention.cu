// Kernel K2: non-causal, unmasked attention softmax(Q K^T / sqrt(d)) V with
// an online softmax; layout (B, H, T, D), contiguous.
//
// Replaces: xmask3d_tpu/ops/flash_attention.py `flash_attention` (kernel body
// `_flash_fwd_kernel`), dispatched by `attention`.
//
// What bounds it on an H100: at the main path's shapes (SD UNet self-attention
// 4096 x d40 / 1024 x d80 / 256 x d160, cross-attention over 77 keys, VAE
// 4096 x d512) the work is 4*Tq*Tk*D FLOPs per head against (3*T + T)*D*2
// bytes, so it is bound by operations: the bf16 tensor cores. No (Tq, Tk)
// score matrix reaches device memory.
//
// Design (bf16): both products run on the tensor cores (mma.sync m16n8k16,
// fp32 accumulators) fed by ldmatrix from bf16 tiles in shared memory. Tiles
// are copied 16 bytes a thread with cp.async; a missing row or column chunk
// (ragged query/key edge, head dim below the padded width) is zero-filled by
// the same copy (src-size 0), so stale shared memory never meets a
// probability of 0. Rows are padded by 8 halves: the row stride is an odd
// multiple of 16 bytes, so the eight rows of an ldmatrix hit eight different
// bank groups. The online softmax (running max and sum, the exponentials) is
// fp32; P is rounded to bf16 only as the A operand of P V, while the row sum
// adds the unrounded fp32 values. Out-of-range key columns get -inf before
// the row max; out-of-range query rows are computed and not stored. A head
// dim that is not a multiple of 8 (or a base pointer off 16 bytes) is staged
// with scalar loads into the same tiles by the same kernel.
//
//  * d <= 160 (`flash_mma_kernel`, widths 48 / 80 / 128 / 160): the
//    FlashAttention-2 layout. A warp owns 16 query rows; S and P stay in
//    registers (the S accumulator fragment is re-packed as the A fragment of
//    P V), the row max is reduced by shuffles inside the quad, the row sum
//    once at the end. K/V tiles of 64 keys go through a ring of three
//    stages, so the tiles ahead load under tile i's math, with one block
//    barrier a tile; a block has 8 warps (128 query rows) for head dims up
//    to 80 when that still gives a block per SM, else 4. Up to 80 keys (cross-attention over 77 text tokens,
//    the 64-token mid block) K/V is one tile and the kernel is instantiated
//    with one stage: no ring, no prologue. For head dims up to 80 the warp
//    keeps its Q fragments in registers; keys are masked only in a tile that
//    crosses the ragged edge; the exponentials are ex2.approx on scores
//    pre-multiplied by log2(e) / sqrt(d).
//  * 160 < d <= 512 (`flash_wide_kernel`, the VAE's single 512-wide head): a
//    16-row strip would need 256 fp32 accumulators a thread, so four warps
//    share a strip. Each computes S for a quarter of the tile's 64 keys over
//    the whole head dim, the four exchange their row maxima and the bf16 P
//    through shared memory, and each keeps 128 of the 512 output columns.
//    K and V have one buffer each and alternate: V(i) loads under S(i),
//    K(i+1) under P V(i), which fits 64-key tiles of 512 columns into the
//    227 KB a block may use.
//
// fp32 inputs (the tiny reference model, the fp32 kernel checks) keep the
// CUDA-core kernel `flash_fma_kernel`: TF32 would not hold their 1e-4.
//
// Backward (bf16, d <= 160; the JAX package takes it from the XLA formulation
// through `custom_vjp`, so it replaces no TPU kernel): a call autograd records
// runs `flash_mma_kernel` with LSE = 1, which also stores each row's
// log-sum-exp, and its backward is three launches, `attn_bwd_rowdot`,
// `attn_bwd_dkdv` and `attn_bwd_dq` (below). The plain VJP it replaces held
// three fp32 (Tq, Tk) matrices at once (4.3 GB each for 8 views of the SD
// UNet's 4096-token calls); these kernels recompute P tile by tile from lse,
// so a call's backward holds its gradients and a row of D and nothing more.
// Like the forward, they are bound by the tensor cores: 9 products of
// 2 Tq Tk d (S three times, dP three times, dV, dK, dQ) against ~9 T d bytes a
// head.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace xm;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// 2^x by the special-function unit (2 ulp; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows row0 .. row0 + ROWS of a (rows, d) matrix whose rows lie `ld` values
// apart into a ROWS x (DP + 8) tile; rows >= rows and columns >= d become
// zeros. vec: 16-byte cp.async chunks (d % 8 == 0, ld % 8 == 0, 16-byte
// aligned base), else scalar loads and one 16-byte store.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int row0, int rows, int d,
                                           int ld, bool vec, int tid) {
  constexpr int CH = DP / 8, LD = DP + 8;
  for (int e = tid; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8;
    const int gr = row0 + r;
    bf16* dp = dst + r * LD + c;
    const bool in = gr < rows && c < d;
    if (vec) {
      cp_async_16(dp, in ? src + (size_t)gr * ld + c : src, in ? 16 : 0);
    } else {
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        bf16* h = reinterpret_cast<bf16*>(&packed);
        const bf16* sp = src + (size_t)gr * ld + c;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < d) h[j] = sp[j];
      }
      *reinterpret_cast<uint4*>(dp) = packed;
    }
  }
}

// Two output rows (g and g + 8 of a warp's strip) of one 8-column n-tile.
__device__ __forceinline__ void store_pair(bf16* o_row, int col, int d, float v0, float v1) {
  if (col >= d) return;
  if ((d & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    o_row[col] = __float2bfloat16(v0);
    if (col + 1 < d) o_row[col + 1] = __float2bfloat16(v1);
  }
}

template <int DP, int NW, int BK, int NS>
struct MmaCfg {
  static constexpr int BQ = 16 * NW, LD = DP + 8, NT = 32 * NW;
  static constexpr size_t bytes = sizeof(bf16) * (size_t)LD * (BQ + 2 * NS * BK);
};

// LSE = 1 also stores each query row's log-sum-exp of the scaled scores
// (natural log, fp32) for the backward; the output is the same either way.
template <int DP, int NW, int BK, int NS, int LSE>
__global__ void __launch_bounds__(32 * NW) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d, float sl2, int vec) {
  using C = MmaCfg<DP, NW, BK, NS>;
  constexpr int BQ = C::BQ, LD = C::LD, NT = C::NT;
  constexpr bool QREG = DP <= 80;  // Q fragments live in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* k_s = q_s + BQ * LD;                      // NS x BK x LD
  bf16* v_s = k_s + NS * BK * LD;                 // NS x BK x LD

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, quad = lane >> 3;
  const bf16* q_b = q + (size_t)bh * tq * d;
  const bf16* k_b = k + (size_t)bh * tk * d;
  const bf16* v_b = v + (size_t)bh * tk * d;
  const int n_tiles = (tk + BK - 1) / BK;

  // Tile it + NS - 1 loads while tile it multiplies. One commit per tile,
  // empty past the end, keeps the group count in step with it.
  stage_tile<BQ, DP, NT>(q_s, q_b, q0, tq, d, d, vec, tid);
  for (int p = 0; p < (NS > 1 ? NS - 1 : 1); ++p) {
    if (p < n_tiles) {
      stage_tile<BK, DP, NT>(k_s + p * BK * LD, k_b, p * BK, tk, d, d, vec, tid);
      stage_tile<BK, DP, NT>(v_s + p * BK * LD, v_b, p * BK, tk, d, d, vec, tid);
    }
    cp_async_commit();
  }

  uint32_t qf[QREG ? DP / 16 : 1][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = NS > 1 ? it % NS : 0;
    cp_async_wait<(NS > 1 ? NS - 2 : 0)>();
    __syncthreads();  // tile it has landed; tile it - 1 is consumed, so its stage is free
    if (NS > 1) {
      const int nx = it + NS - 1;
      if (nx < n_tiles) {
        stage_tile<BK, DP, NT>(k_s + (nx % NS) * BK * LD, k_b, nx * BK, tk, d, d, vec, tid);
        stage_tile<BK, DP, NT>(v_s + (nx % NS) * BK * LD, v_b, nx * BK, tk, d, d, vec, tid);
      }
      cp_async_commit();
    }
    if (QREG && it == 0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
    }
    const bf16* kb = k_s + buf * BK * LD;
    const bf16* vb = v_s + buf * BK * LD;

    // S = Q K^T for the warp's 16 rows x BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a_ld[4];
      if (!QREG)
        ldmatrix_x4(a_ld, q_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      const uint32_t(&a)[4] = QREG ? qf[ks] : a_ld;
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + (np * 16 + (quad >> 1) * 8 + (lane & 7)) * LD + ks * 16 + (quad & 1) * 8);
        mma_16816(s[2 * np], a, b[0], b[1]);
        mma_16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // online softmax in fp32; thread holds rows g (e 0, 1) and g + 8 (e 2, 3)
    const int kmax = tk - it * BK;
    if (kmax < BK) {  // the ragged edge: keys past it get -inf before the max
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * t + (e & 1) >= kmax) s[j][e] = -INFINITY;
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);  // finite: a tile's first key is in range
      alpha[r] = fast_exp2((m_run[r] - m_new) * sl2);
      m_run[r] = m_new;
      mb[r] = m_new * sl2;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] * sl2 - mb[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + (kk * 16 + (quad & 1) * 8 + (lane & 7)) * LD + np * 16 + (quad >> 1) * 8);
        mma_16816(acc[2 * np], a, b[0], b[1]);
        mma_16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= tq) continue;
    if (LSE && t == 0)  // log2 of the row's sum of 2^(s sl2), in natural-log units
      lse[(size_t)bh * tq + qi] = (m_run[r] * sl2 + log2f(l_run[r])) * 0.6931471805599453f;
    const float inv = 1.f / l_run[r];
    bf16* o_row = o + ((size_t)bh * tq + qi) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      store_pair(o_row, j * 8 + 2 * t, d, acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

// 160 < d <= 512: NRG strips of 16 query rows, four warps a strip.
template <int NRG>
struct WideCfg {
  static constexpr int DP = 512, BK = 64, BQ = 16 * NRG, LD = DP + 8, PLD = BK + 8;
  static constexpr int NT = 128 * NRG;
  static constexpr size_t bytes = sizeof(bf16) * ((size_t)LD * (BQ + 2 * BK) + (size_t)BQ * PLD) +
                                  sizeof(float) * 4 * BQ;
};

template <int NRG>
__global__ void __launch_bounds__(128 * NRG) flash_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int tq, int tk, int d, float sl2, int vec) {
  using C = WideCfg<NRG>;
  constexpr int DP = C::DP, BK = C::BK, BQ = C::BQ, LD = C::LD, PLD = C::PLD, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* k_s = q_s + BQ * LD;                      // BK x LD
  bf16* v_s = k_s + BK * LD;                      // BK x LD
  bf16* p_s = v_s + BK * LD;                      // BQ x PLD
  float* x_s = reinterpret_cast<float*>(p_s + BQ * PLD);  // 4 x BQ: row maxima, then row sums

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp >> 2, cq = warp & 3;  // strip, quarter (of the keys for S, of the columns for O)
  const int g = lane >> 2, t = lane & 3, quad = lane >> 3;
  const bf16* q_b = q + (size_t)bh * tq * d;
  const bf16* k_b = k + (size_t)bh * tk * d;
  const bf16* v_b = v + (size_t)bh * tk * d;
  const int n_tiles = (tk + BK - 1) / BK;

  stage_tile<BQ, DP, NT>(q_s, q_b, q0, tq, d, d, vec, tid);
  stage_tile<BK, DP, NT>(k_s, k_b, 0, tk, d, d, vec, tid);
  cp_async_commit();
  stage_tile<BK, DP, NT>(v_s, v_b, 0, tk, d, d, vec, tid);
  cp_async_commit();

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int row_a = rg * 16 + (lane & 15);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();  // K(it) is here; V(it) may still be in flight
    __syncthreads();

    // S for 16 rows x this warp's 16 keys
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, q_s + row_a * LD + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(b, k_s + (cq * 16 + (quad >> 1) * 8 + (lane & 7)) * LD + ks * 16 + (quad & 1) * 8);
      mma_16816(s[0], a, b[0], b[1]);
      mma_16816(s[1], a, b[2], b[3]);
    }
    const int kmax = tk - it * BK;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (cq * 16 + j * 8 + 2 * t + (e & 1) >= kmax) s[j][e] = -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      if (t == 0) x_s[cq * BQ + rg * 16 + g + 8 * r] = mt[r];
    }
    __syncthreads();  // maxima visible; K(it) consumed
    if (it + 1 < n_tiles) stage_tile<BK, DP, NT>(k_s, k_b, (it + 1) * BK, tk, d, d, vec, tid);
    cp_async_commit();

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * 16 + g + 8 * r;
      const float m_tile = fmaxf(fmaxf(x_s[row], x_s[BQ + row]), fmaxf(x_s[2 * BQ + row], x_s[3 * BQ + row]));
      const float m_new = fmaxf(m_run[r], m_tile);
      alpha[r] = fast_exp2((m_run[r] - m_new) * sl2);
      m_run[r] = m_new;
      const float mb = m_new * sl2;
      l_run[r] *= alpha[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p0 = fast_exp2(s[j][2 * r] * sl2 - mb), p1 = fast_exp2(s[j][2 * r + 1] * sl2 - mb);
        l_run[r] += p0 + p1;  // this warp's keys only; the quarters are added at the end
        *reinterpret_cast<uint32_t*>(p_s + row * PLD + cq * 16 + j * 8 + 2 * t) = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    cp_async_wait<1>();  // V(it) is here; K(it + 1) may still be in flight
    __syncthreads();     // P visible

    // O[:, 128 cq ..] += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, p_s + row_a * PLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + (kk * 16 + (quad & 1) * 8 + (lane & 7)) * LD + cq * 128 + np * 16 + (quad >> 1) * 8);
        mma_16816(acc[2 * np], a, b[0], b[1]);
        mma_16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // V(it), P and the maxima consumed
    if (it + 1 < n_tiles) stage_tile<BK, DP, NT>(v_s, v_b, (it + 1) * BK, tk, d, d, vec, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (t == 0) x_s[cq * BQ + rg * 16 + g + 8 * r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rg * 16 + g + 8 * r;
    const int qi = q0 + row;
    if (qi >= tq) continue;
    const float inv = 1.f / (x_s[row] + x_s[BQ + row] + x_s[2 * BQ + row] + x_s[3 * BQ + row]);
    bf16* o_row = o + ((size_t)bh * tq + qi) * d;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store_pair(o_row, cq * 128 + j * 8 + 2 * t, d, acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <int DP, int NW, int BK, int NS, int LSE>
int run_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int tq,
            int tk, int d, float sl2, int vec, cudaStream_t stream) {
  using C = MmaCfg<DP, NW, BK, NS>;
  auto kern = flash_mma_kernel<DP, NW, BK, NS, LSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, C::NT, C::bytes, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                                          lse, tq, tk, d, sl2, vec);
  return (int)cudaGetLastError();
}

template <int DP, int LSE>
int run_mma_dp(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int tq,
               int tk, int d, float sl2, int vec, int single, cudaStream_t s) {
  if (single) return run_mma<DP, 4, 80, 1, LSE>(q, k, v, o, lse, bh, tq, tk, d, sl2, vec, s);
  // narrow heads with enough query rows to fill the card's 132 SMs with
  // 128-row blocks: 8 warps a block. Measured at 4096 x 4096 x d40 with three
  // stages: 126 us against 146 with 4 warps (150 with two stages, 198 with
  // 128-key tiles; NVIDIA H100 80GB HBM3, 700 W).
  if constexpr (DP <= 80) {
    if ((long)((tq + 127) / 128) * bh >= 132)
      return run_mma<DP, 8, 64, 3, LSE>(q, k, v, o, lse, bh, tq, tk, d, sl2, vec, s);
  }
  return run_mma<DP, 4, 64, 3, LSE>(q, k, v, o, lse, bh, tq, tk, d, sl2, vec, s);
}

template <int NRG>
int run_wide(const void* q, const void* k, const void* v, void* o, int bh, int tq, int tk, int d,
             float sl2, int vec, cudaStream_t stream) {
  using C = WideCfg<NRG>;
  auto kern = flash_wide_kernel<NRG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, C::NT, C::bytes, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                                          tq, tk, d, sl2, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 backward (FlashAttention-2): the forward under a gradient saved the
// row log-sum-exp; P = exp(S / sqrt(d) - lse) is recomputed tile by tile and
// no (Tq, Tk) matrix reaches device memory. Three launches:
//   attn_bwd_rowdot: a block per (b*h, 64-query tile); each warp owns 16
//                    queries and walks the key tiles: S, P, dP = dO V^T,
//                    D = rowsum(P o dP) (= rowsum(dO o O) for the unrounded O);
//   attn_bwd_dkdv:   a block per (b*h, 64-key tile); each warp owns 16 keys
//                    and walks the query tiles: S^T = K Q^T, P^T, dV += P^T dO,
//                    dP^T = V dO^T, dS^T = P^T o (dP^T - D), dK += dS^T Q;
//   attn_bwd_dq:     the rowdot walk again with D known: dS, dQ += dS K.
// Each warp computes the transposed product (keys as rows) where its rows
// are keys, so P^T and dS^T leave the accumulators as the A operands of the
// next product, as P does in the forward: nothing goes through shared memory
// but the staged tiles. Every gradient is summed by one thread in a fixed
// order (no atomics): the same inputs give the same bits. Products run on
// the tensor cores in bf16 (P and dS rounded as operands only) with fp32
// accumulators; exponentials, D and dP - D are fp32. Tiles come through the
// forward's `stage_tile` (cp.async, zero-filled edges), two stages a ring.
// Ragged edges: a missing query row is zeros in Q and dO with lse = D = 0,
// so its P is 1 and its dP and dS 0; a missing key gets P = 0 in the query
// walks, and its dK / dV rows are never stored.
// ---------------------------------------------------------------------------

// 4-byte asynchronous copy (src-size 0 writes a zero): the lse and D rows
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src), "r"(bytes)
               : "memory");
}

// the rows of dO, which autograd may hand over as a view of (B, T, H, d)
struct RowView {
  const bf16* p;
  int heads, sb, sh, st;  // strides in values of batch, head, row (the column stride is 1)
  __device__ __forceinline__ const bf16* head(int bh) const {
    return p + (size_t)(bh / heads) * sb + (size_t)(bh % heads) * sh;
  }
};

// 16 rows (keys or queries) of this warp x BN columns (queries or keys):
// acc = A B^T over the head dim, A from `a_s` (rows warp*16.., or the
// fragments `af` when AREG), B rows from `b_s`; both tiles of stride LD.
template <int DP, int BN, bool AREG>
__device__ __forceinline__ void warp_abt(float (&acc)[BN / 8][4], const uint32_t (&af)[AREG ? DP / 16 : 1][4],
                                         const bf16* a_s, const bf16* b_s, int warp, int lane) {
  constexpr int LD = DP + 8;
  const int quad = lane >> 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    uint32_t a[4];
    if constexpr (AREG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = af[ks][i];
    } else {
      ldmatrix_x4(a, a_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_s + (np * 16 + (quad >> 1) * 8 + (lane & 7)) * LD + ks * 16 + (quad & 1) * 8);
      mma_16816(acc[2 * np], a, b[0], b[1]);
      mma_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out (16 x DP) += X B, X the warp's 16 x BN fp32 accumulator rounded to bf16
// as the A operand, B a BN x DP tile of stride LD (rows along X's columns)
template <int DP, int BN>
__device__ __forceinline__ void warp_xb(float (&out)[DP / 8][4], const float (&x)[BN / 8][4],
                                        const bf16* b_s, int lane) {
  constexpr int LD = DP + 8;
  const int quad = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_s + (kk * 16 + (quad & 1) * 8 + (lane & 7)) * LD + np * 16 + (quad >> 1) * 8);
      mma_16816(out[2 * np], a, b[0], b[1]);
      mma_16816(out[2 * np + 1], a, b[2], b[3]);
    }
  }
}

template <int DP, int BQ>
struct DkdvCfg {
  static constexpr int NW = 4, BK = 64, NS = 2, LD = DP + 8, NT = 32 * NW;
  static constexpr size_t bytes =
      sizeof(bf16) * (size_t)LD * (2 * BK + 2 * NS * BQ) + sizeof(float) * 2 * NS * BQ;
};

template <int DP, int BQ>
__global__ void __launch_bounds__(128) attn_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    RowView dout, const float* __restrict__ lse, const float* __restrict__ dd,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk, int d, float sl2, float scale,
    int vec) {
  using C = DkdvCfg<DP, BQ>;
  constexpr int BK = C::BK, NS = C::NS, LD = C::LD, NT = C::NT;
  constexpr bool AREG = DP <= 48;  // K and V fragments live in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // BK x LD
  bf16* v_s = k_s + BK * LD;                      // BK x LD
  bf16* q_s = v_s + BK * LD;                      // NS x BQ x LD
  bf16* g_s = q_s + NS * BQ * LD;                 // NS x BQ x LD (dO)
  float* l_s = reinterpret_cast<float*>(g_s + NS * BQ * LD);  // NS x BQ (lse, log2 units later)
  float* d_s = l_s + NS * BQ;                                 // NS x BQ

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3;
  const bf16* q_b = q + (size_t)bh * tq * d;
  const bf16* g_b = dout.head(bh);
  const float* l_b = lse + (size_t)bh * tq;
  const float* d_b = dd + (size_t)bh * tq;
  const int n_tiles = (tq + BQ - 1) / BQ;

  auto stage = [&](int i) {
    const int buf = i % NS;
    stage_tile<BQ, DP, NT>(q_s + buf * BQ * LD, q_b, i * BQ, tq, d, d, vec, tid);
    stage_tile<BQ, DP, NT>(g_s + buf * BQ * LD, g_b, i * BQ, tq, d, dout.st, vec, tid);
    for (int e = tid; e < BQ; e += NT) {
      const int qi = i * BQ + e;
      cp_async_4(l_s + buf * BQ + e, qi < tq ? l_b + qi : l_b, qi < tq ? 4 : 0);
      cp_async_4(d_s + buf * BQ + e, qi < tq ? d_b + qi : d_b, qi < tq ? 4 : 0);
    }
  };
  stage_tile<BK, DP, NT>(k_s, k + (size_t)bh * tk * d, k0, tk, d, d, vec, tid);
  stage_tile<BK, DP, NT>(v_s, v + (size_t)bh * tk * d, k0, tk, d, d, vec, tid);
  stage(0);
  cp_async_commit();

  uint32_t kf[AREG ? DP / 16 : 1][4], vf[AREG ? DP / 16 : 1][4];
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % NS;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1 is consumed, so its stage is free
    if (it + 1 < n_tiles) stage(it + 1);
    cp_async_commit();
    if (AREG && it == 0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        ldmatrix_x4(kf[ks], k_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x4(vf[ks], v_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* qb = q_s + buf * BQ * LD;
    const bf16* gb = g_s + buf * BQ * LD;
    const float* lb = l_s + buf * BQ;
    const float* db = d_s + buf * BQ;

    // P^T = exp(S^T / sqrt(d) - lse): this warp's 16 keys x BQ queries
    float p[BQ / 8][4];
    warp_abt<DP, BQ, AREG>(p, kf, k_s, qb, warp, lane);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lb + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = fast_exp2(p[j][e] * sl2 - ((e & 1) ? l2.y : l2.x) * 1.4426950408889634f);
    }
    warp_xb<DP, BQ>(dv_acc, p, gb, lane);  // dV += P^T dO

    // dS^T = P^T o (dP^T - D), dP^T = V dO^T
    float ds[BQ / 8][4];
    warp_abt<DP, BQ, AREG>(ds, vf, v_s, gb, warp, lane);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(db + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - ((e & 1) ? d2.y : d2.x));
    }
    warp_xb<DP, BQ>(dk_acc, ds, qb, lane);  // dK += dS^T Q (scaled at the store)
  }
  cp_async_wait<0>();

  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + warp * 16 + g + 8 * r;
    if (ki >= tk) continue;
    bf16* dk_row = dk + ((size_t)bh * tk + ki) * d;
    bf16* dv_row = dv + ((size_t)bh * tk + ki) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      store_pair(dk_row, j * 8 + 2 * t, d, dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      store_pair(dv_row, j * 8 + 2 * t, d, dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

template <int DP>
struct DqCfg {
  static constexpr int NW = 4, BQ = 64, BK = 64, NS = 2, LD = DP + 8, NT = 32 * NW;
  static constexpr size_t bytes = sizeof(bf16) * (size_t)LD * (2 * BQ + 2 * NS * BK);
};

// A block's 64 queries against every key tile: S, P and dP = dO V^T. ROWDOT
// sums D = rowsum(P o dP) and stores it; else it reads D and accumulates
// dQ += dS K, dS = P o (dP - D), and stores dQ.
template <int DP, bool ROWDOT>
__device__ __forceinline__ void query_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const RowView& dout, const float* __restrict__ lse, float* __restrict__ dd,
    bf16* __restrict__ dq, int tq, int tk, int d, float sl2, float scale, int vec) {
  using C = DqCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, LD = C::LD, NT = C::NT;
  constexpr bool AREG = DP <= 80;  // Q and dO fragments live in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* g_s = q_s + BQ * LD;                      // BQ x LD (dO)
  bf16* k_s = g_s + BQ * LD;                      // NS x BK x LD
  bf16* v_s = k_s + NS * BK * LD;                 // NS x BK x LD

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* k_b = k + (size_t)bh * tk * d;
  const bf16* v_b = v + (size_t)bh * tk * d;
  const int n_tiles = (tk + BK - 1) / BK;

  stage_tile<BQ, DP, NT>(q_s, q + (size_t)bh * tq * d, q0, tq, d, d, vec, tid);
  stage_tile<BQ, DP, NT>(g_s, dout.head(bh), q0, tq, d, dout.st, vec, tid);
  stage_tile<BK, DP, NT>(k_s, k_b, 0, tk, d, d, vec, tid);
  stage_tile<BK, DP, NT>(v_s, v_b, 0, tk, d, d, vec, tid);
  cp_async_commit();

  float l2[2], dr[2];  // the rows' lse in log2 units and D (0 past the edge, or summed here)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    l2[r] = qi < tq ? lse[(size_t)bh * tq + qi] * 1.4426950408889634f : 0.f;
    dr[r] = qi < tq && !ROWDOT ? dd[(size_t)bh * tq + qi] : 0.f;
  }
  uint32_t qf[AREG ? DP / 16 : 1][4], gf[AREG ? DP / 16 : 1][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % NS;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1 is consumed, so its stage is free
    if (it + 1 < n_tiles) {
      stage_tile<BK, DP, NT>(k_s + (buf ^ 1) * BK * LD, k_b, (it + 1) * BK, tk, d, d, vec, tid);
      stage_tile<BK, DP, NT>(v_s + (buf ^ 1) * BK * LD, v_b, (it + 1) * BK, tk, d, d, vec, tid);
    }
    cp_async_commit();
    if (AREG && it == 0) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x4(gf[ks], g_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* kb = k_s + buf * BK * LD;
    const bf16* vb = v_s + buf * BK * LD;

    // P = exp(S / sqrt(d) - lse): this warp's 16 queries x BK keys
    float p[BK / 8][4];
    warp_abt<DP, BK, AREG>(p, qf, q_s, kb, warp, lane);
    const int kmax = tk - it * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = j * 8 + 2 * t + (e & 1) < kmax ? fast_exp2(p[j][e] * sl2 - l2[e >> 1]) : 0.f;

    // dP = dO V^T; then D += P o dP, or dS = P o (dP - D)
    float ds[BK / 8][4];
    warp_abt<DP, BK, AREG>(ds, gf, g_s, vb, warp, lane);
    if constexpr (ROWDOT) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dr[e >> 1] = fmaf(p[j][e], ds[j][e], dr[e >> 1]);
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dr[e >> 1]);
      warp_xb<DP, BK>(acc, ds, kb, lane);  // dQ += dS K (scaled at the store)
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if constexpr (ROWDOT) {  // the quad's four partial sums, in a fixed order
      dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 1);
      dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 2);
      if (qi < tq && t == 0) dd[(size_t)bh * tq + qi] = dr[r];
    } else {
      if (qi >= tq) continue;
      bf16* row = dq + ((size_t)bh * tq + qi) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        store_pair(row, j * 8 + 2 * t, d, acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

// D = rowsum(dO o O) for the unrounded O = P V, as rowsum(P o dP): the bf16
// output the forward stored would put D's rounding, times the keys' common
// component, into every dQ (1-2.5x the tolerance on the SD UNet's calls)
template <int DP>
__global__ void __launch_bounds__(128) attn_bwd_rowdot_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    RowView dout, const float* __restrict__ lse, float* __restrict__ dd, int tq, int tk, int d,
    float sl2, int vec) {
  query_walk<DP, true>(q, k, v, dout, lse, dd, nullptr, tq, tk, d, sl2, 0.f, vec);
}

template <int DP>
__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    RowView dout, const float* __restrict__ lse, float* __restrict__ dd, bf16* __restrict__ dq,
    int tq, int tk, int d, float sl2, float scale, int vec) {
  query_walk<DP, false>(q, k, v, dout, lse, dd, dq, tq, tk, d, sl2, scale, vec);
}

template <int DP>
int run_backward(const void* q, const void* k, const void* v, RowView dout, const float* lse,
                 float* dd, void* dq, void* dk, void* dv, int bh, int tq, int tk, int d, float sl2,
                 float scale, int vec, cudaStream_t s) {
  using Q = DqCfg<DP>;
  const dim3 q_grid((tq + Q::BQ - 1) / Q::BQ, bh);
  auto rowdot = attn_bwd_rowdot_kernel<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(rowdot, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::bytes);
  if (err != cudaSuccess) return (int)err;
  rowdot<<<q_grid, Q::NT, Q::bytes, s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, dout, lse,
                                         dd, tq, tk, d, sl2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dk != nullptr) {
    constexpr int BQ = DP <= 80 ? 64 : 32;  // 160 wide: fewer score registers beside dK and dV
    using C = DkdvCfg<DP, BQ>;
    auto kern = attn_bwd_dkdv_kernel<DP, BQ>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((tk + C::BK - 1) / C::BK, bh), C::NT, C::bytes, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, dout, lse, dd, (bf16*)dk, (bf16*)dv, tq, tk,
        d, sl2, scale, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dq != nullptr) {
    auto kern = attn_bwd_dq_kernel<DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<q_grid, Q::NT, Q::bytes, s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, dout, lse,
                                         dd, (bf16*)dq, tq, tk, d, sl2, scale, vec);
    err = cudaGetLastError();
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs. One block per (batch*head, tile of BQ queries); Q
// (pre-scaled), K and V tiles staged in shared memory; a group of G = NT/BQ
// adjacent lanes owns one query row, P goes through shared memory.
// ---------------------------------------------------------------------------

template <int BQ, int BK, int DP, int NT>
struct FmaSmem {
  static constexpr int QS = DP + 1;  // padded row stride (bank spread)
  static constexpr int PS = BK + 1;
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)BQ * QS + (size_t)BK * QS + (size_t)BK * DP + (size_t)BQ * PS);
};

template <int BQ, int BK, int DP, int NT>
__global__ void __launch_bounds__(NT) flash_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int tq, int tk, int d, float scale) {
  constexpr int G = NT / BQ;       // lanes per query row
  constexpr int SPL = BK / G;      // scores per lane
  constexpr int OPL = DP / G;      // output columns per lane
  using S = FmaSmem<BQ, BK, DP, NT>;
  static_assert(32 % G == 0, "a row group must sit inside one warp");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // BQ x QS
  float* k_s = q_s + BQ * S::QS;                    // BK x QS
  float* v_s = k_s + BK * S::QS;                    // BK x DP
  float* p_s = v_s + BK * DP;                       // BQ x PS

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
    q_s[r * S::QS + c] = qi < tq ? q[base_q + (size_t)qi * d + c] * scale : 0.f;
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
        kv = k[base_k + (size_t)ki * d + c];
        vv = v[base_k + (size_t)ki * d + c];
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
    float* orow = o + base_q + (size_t)qi * d;
#pragma unroll
    for (int j = 0; j < OPL; ++j) {
      const int col = g + G * j;
      if (col < d) orow[col] = acc[j] * inv;
    }
  }
}

template <int BQ, int BK, int DP, int NT>
int run_fma(const void* q, const void* k, const void* v, void* o, int bh, int tq, int tk, int d,
            float scale, cudaStream_t stream) {
  using S = FmaSmem<BQ, BK, DP, NT>;
  auto kern = flash_fma_kernel<BQ, BK, DP, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + BQ - 1) / BQ, bh);
  kern<<<grid, NT, S::bytes, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                       (float*)o, tq, tk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xm_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      int bh, int tq, int tk, int d, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  if (tk <= 0) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64) return run_fma<64, 64, 64, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  if (d <= 96) return run_fma<64, 64, 96, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  if (d <= 160) return run_fma<64, 64, 160, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  if (d <= 512) return run_fma<32, 32, 512, 256>(q, k, v, o, bh, tq, tk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dp: the padded head dim of the variant (48, 80, 128, 160 or 512); single: K/V
// is one tile of at most 80 keys (dp <= 160 only); vec: 16-byte copies allowed.
// The wrapper chooses all three (`variant` in ops/flash_attention.py). A
// non-null lse (bh x tq fp32) also receives each row's log-sum-exp for the
// backward; dp is then the backward's width, 48, 80 or 160 (`backward_plan`).
extern "C" int xm_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int bh, int tq, int tk, int d, int dp,
                                       int single, int vec, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  if (tk <= 0 || d > dp || (single && tk > 80)) return (int)cudaErrorInvalidValue;
  const float sl2 = 1.4426950408889634f / sqrtf((float)d);
  cudaStream_t s = (cudaStream_t)stream;
  if (lse != nullptr) {
    switch (dp) {
      case 48: return run_mma_dp<48, 1>(q, k, v, o, lse, bh, tq, tk, d, sl2, vec, single, s);
      case 80: return run_mma_dp<80, 1>(q, k, v, o, lse, bh, tq, tk, d, sl2, vec, single, s);
      case 160: return run_mma_dp<160, 1>(q, k, v, o, lse, bh, tq, tk, d, sl2, vec, single, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (dp) {
    case 48: return run_mma_dp<48, 0>(q, k, v, o, nullptr, bh, tq, tk, d, sl2, vec, single, s);
    case 80: return run_mma_dp<80, 0>(q, k, v, o, nullptr, bh, tq, tk, d, sl2, vec, single, s);
    case 128: return run_mma_dp<128, 0>(q, k, v, o, nullptr, bh, tq, tk, d, sl2, vec, single, s);
    case 160: return run_mma_dp<160, 0>(q, k, v, o, nullptr, bh, tq, tk, d, sl2, vec, single, s);
    case 512:
      if (single) return (int)cudaErrorInvalidValue;
      return run_wide<2>(q, k, v, o, bh, tq, tk, d, sl2, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dQ, dK, dV of a bf16 call from q, k, v (contiguous (B, H, T, d)), dO
// (rows of d values with strides sb / sh / st along batch, head and row), the
// forward's lse and D scratch (bh x tq fp32). dq, or dk and dv together, may be
// null: that launch is skipped. dp 48, 80 or 160; vec: 16-byte copies of q,
// k, v and dO's rows allowed (d, the bases and dO's strides on 16 bytes).
extern "C" int xm_attn_backward_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, float* dd, void* dq,
                                     void* dk, void* dv, int batch, int heads, int tq, int tk,
                                     int d, int sb, int sh, int st, int dp, int vec, void* stream) {
  const int bh = batch * heads;
  if (bh <= 0 || tq <= 0) return 0;
  if (tk <= 0 || d > dp || (dk == nullptr) != (dv == nullptr)) return (int)cudaErrorInvalidValue;
  const float sl2 = 1.4426950408889634f / sqrtf((float)d), scale = 1.f / sqrtf((float)d);
  const RowView g{(const bf16*)dout, heads, sb, sh, st};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dp) {
    case 48: return run_backward<48>(q, k, v, g, lse, dd, dq, dk, dv, bh, tq, tk, d, sl2, scale, vec, s);
    case 80: return run_backward<80>(q, k, v, g, lse, dd, dq, dk, dv, bh, tq, tk, d, sl2, scale, vec, s);
    case 160: return run_backward<160>(q, k, v, g, lse, dd, dq, dk, dv, bh, tq, tk, d, sl2, scale, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
