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
// is ~0.1 ms, set by bytes. With the products on the tensor cores, what the
// kernel really waits for is the gather: every input row is fetched once per
// tap that hits it (K*V*C_in*2 bytes at most, served mostly from L2) and
// W[k] once per block and tap.
//
// Design (bf16, `sparse_conv_mma_kernel`): a block of four warps owns 64
// output voxels and all of C_out up to 256 (template widths 32 / 64 / 128 /
// 256; wider layers tile C_out over the grid), so a row is gathered once per
// tap and not once per tap and channel tile. A warp owns 16 rows and keeps
// their fp32 accumulators (C_out / 2 registers a thread) across all taps;
// the products are mma.sync m16n8k16 fed by ldmatrix. The block first loads
// its map entries for all taps (dead rows as -1), marks per tap which of its
// four 16-row strips has a hit, and makes the list of taps with any hit.
// It then walks (tap, channel chunk) steps through a ring of stages (chunks
// of 64 channels in three stages where C_in is a multiple of 64, else of 32
// in four): the 64 gathered rows (16-byte cp.async copies of bf16 rows,
// zero-filled by src-size 0 for a missing neighbour) and the chunk's slice
// of W[k] (row-major as stored, read by ldmatrix.trans) for the steps ahead
// load under step s's math, with one block barrier a step. A step is small
// (a few KB from L2), so what it costs is the round trip, and the ring is
// what hides it. Where a level has too few 64-row tiles to fill the card's
// 132 SMs (the deep levels: 1536-6144 rows of 128-256 channels) the wrapper
// narrows the block to 64 output channels and C_out is tiled over the grid:
// rows are then gathered once per channel tile again, which costs less than
// idle SMs. The deep levels also hold few live rows (some hundred of 1536-
// 6144), so a handful of blocks would each walk 27 taps x C_in / 64 steps
// alone on their SMs, every instruction's latency exposed: there the wrapper
// splits a tile's taps over `split` blocks (block z takes the tile's live
// taps z, z + split, ...), each writes its fp32 partial sums to scratch, and
// `sparse_conv_reduce_kernel` adds the shares in a fixed order, then bias, zeroing
// and cast. Taps no row of the block hits are never staged; a warp
// skips a step when none of its own 16 rows hits. Rows are padded by 8
// halves so that ldmatrix touches no bank twice. Bias, `out_valid` zeroing
// and the cast happen in the epilogue; a tile with no live row only writes
// zeros.
//
// Widths off the 16-byte copy (C_in or C_out not a multiple of 8: the fused
// k5 stem with C_in = 3 and 125 taps, odd test widths) take the same kernel
// in its packed mode: taps and channels form one K dimension of n_taps *
// C_in (an im2col row per voxel, made in shared memory by scalar loads, K
// padded with zeros to the chunk), against W viewed as (n_taps * C_in,
// C_out), which is how it lies in memory. The sums are the same.
//
// fp32 inputs (the tiny reference model, the fp32 kernel checks) keep the
// CUDA-core kernel `sparse_conv_fma_kernel`: TF32 would not hold their 1e-4.
// Indices stay int32 end to end.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace xm;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TV = 64;        // output voxels per block (4 warps x 16 rows)
constexpr int NT = 128;       // threads per block

// NC: output channels a block holds; KC: K (input channels) per staged chunk;
// NS: stages of the ring
template <int NC, int KC, int NS>
struct MmaCfg {
  static constexpr int ALD = KC + 8;  // padded row of the gathered tile, in halves
  static constexpr int WLD = NC + 8;  // padded row of the weight tile, in halves
  static constexpr size_t tiles = sizeof(bf16) * NS * ((size_t)TV * ALD + (size_t)KC * WLD);
  // + per tap: 64 map entries, its strip mask, its slot in the list; + the count
  static size_t bytes(int n_taps) { return tiles + sizeof(int) * ((size_t)n_taps * (TV + 2) + 4); }
};

template <int NC, int KC, int NS>
__global__ void __launch_bounds__(NT) sparse_conv_mma_kernel(
    const bf16* __restrict__ feats,     // (B, V_in, C_in)
    const bf16* __restrict__ w,         // (K, C_in, C_out)
    const int* __restrict__ kmap,       // (B, K, V_out)
    const float* __restrict__ bias,     // (C_out) or null
    const uint8_t* __restrict__ valid,  // (B, V_out) or null
    bf16* __restrict__ out,             // (B, V_out, C_out)
    float* __restrict__ part,           // (split, B, V_out, C_out) when split > 1
    int v_in, int c_in, int c_out, int n_taps, int v_out, int packed, int split) {
  using C = MmaCfg<NC, KC, NS>;
  constexpr int ALD = C::ALD, WLD = C::WLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // NS x TV x ALD
  bf16* w_s = a_s + NS * TV * ALD;                // NS x KC x WLD
  int* idx_s = reinterpret_cast<int*>(w_s + NS * KC * WLD);  // n_taps x TV
  int* mask_s = idx_s + n_taps * TV;              // n_taps: bit i = strip i has a hit
  int* list_s = mask_s + n_taps;                  // taps with any hit, in order
  int* count_s = list_s + n_taps;

  const int b = blockIdx.z / split;
  const int z = blockIdx.z % split;  // this block's share of the K dimension
  const int v0 = blockIdx.x * TV;
  const int n0 = blockIdx.y * NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, quad = lane >> 3;
  const uint8_t* valid_b = valid ? valid + (size_t)b * v_out : nullptr;
  const bf16* feats_b = feats + (size_t)b * v_in * c_in;
  const int* kmap_b = kmap + (size_t)b * n_taps * v_out;

  int my_live = 0;
  if (tid < TV) {
    const int v = v0 + tid;
    my_live = (v < v_out) && (valid_b == nullptr || valid_b[v]);
  }
  const int tile_live = __syncthreads_or(my_live);

  float acc[NC / 8][4];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (tile_live) {
    // the tile's map entries for every tap; a dead row reads as all-missing
    for (int e = tid; e < n_taps * TV; e += NT) {
      const int v = v0 + (e & (TV - 1));
      const bool live = (v < v_out) && (valid_b == nullptr || valid_b[v]);
      idx_s[e] = live ? kmap_b[(size_t)(e / TV) * v_out + v] : -1;
    }
    __syncthreads();
    for (int k = warp; k < n_taps; k += NT / 32) {
      const unsigned lo = __ballot_sync(0xffffffffu, idx_s[k * TV + lane] >= 0);
      const unsigned hi = __ballot_sync(0xffffffffu, idx_s[k * TV + 32 + lane] >= 0);
      if (lane == 0)
        mask_s[k] = ((lo & 0xffffu) ? 1 : 0) | ((lo >> 16) ? 2 : 0) | ((hi & 0xffffu) ? 4 : 0) |
                    ((hi >> 16) ? 8 : 0);
    }
    __syncthreads();
    if (warp == 0) {
      int cnt = 0;
      for (int base = 0; base < n_taps; base += 32) {
        const int k = base + lane;
        const bool act = k < n_taps && mask_s[k] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, act);
        if (act) list_s[cnt + __popc(bal & ((1u << lane) - 1u))] = k;
        cnt += __popc(bal);
      }
      if (lane == 0) *count_s = cnt;
    }
    __syncthreads();

    // Units of K: the taps with a hit (gather mode, n_chunks steps each) or
    // the chunks of the packed K dimension. This block takes units z, z +
    // split, ...
    const int n_act = *count_s;
    const int ktot = n_taps * c_in;                    // packed mode's K
    const int n_chunks = packed ? 1 : (c_in + KC - 1) / KC;
    const int n_units = n_act == 0 ? 0 : (packed ? (ktot + KC - 1) / KC : n_act);
    const int n_steps = (n_units > z ? (n_units - z + split - 1) / split : 0) * n_chunks;

    auto stage = [&](int s, int buf) {
      bf16* a_d = a_s + buf * TV * ALD;
      bf16* w_d = w_s + buf * KC * WLD;
      if (!packed) {
        const int tap = list_s[z + (s / n_chunks) * split];
        const int c0 = (s % n_chunks) * KC;
        for (int e = tid; e < TV * (KC / 8); e += NT) {
          const int r = e / (KC / 8), c = (e % (KC / 8)) * 8;
          const int id = idx_s[tap * TV + r];
          const bool in = id >= 0 && c0 + c < c_in;
          cp_async_16(a_d + r * ALD + c, in ? feats_b + (size_t)id * c_in + c0 + c : feats,
                      in ? 16 : 0);
        }
        const bf16* w_k = w + ((size_t)tap * c_in + c0) * c_out + n0;
        for (int e = tid; e < KC * (NC / 8); e += NT) {
          const int i = e / (NC / 8), c = (e % (NC / 8)) * 8;
          const bool in = c0 + i < c_in && n0 + c < c_out;
          cp_async_16(w_d + i * WLD + c, in ? w_k + (size_t)i * c_out + c : w, in ? 16 : 0);
        }
      } else {
        const int kk0 = (z + s * split) * KC;
        for (int e = tid; e < TV * KC; e += NT) {
          const int r = e / KC, kk = kk0 + e % KC;
          bf16 val = __float2bfloat16(0.f);
          if (kk < ktot) {
            const int tap = kk / c_in;
            const int id = idx_s[tap * TV + r];
            if (id >= 0) val = feats_b[(size_t)id * c_in + (kk - tap * c_in)];
          }
          a_d[r * ALD + e % KC] = val;
        }
        for (int e = tid; e < KC * NC; e += NT) {
          const int i = e / NC, n = e % NC;
          const bool in = kk0 + i < ktot && n0 + n < c_out;
          w_d[i * WLD + n] = in ? w[(size_t)(kk0 + i) * c_out + n0 + n] : __float2bfloat16(0.f);
        }
      }
    };

    // Step s + NS - 1 loads while step s multiplies. One commit per step,
    // empty past the end, keeps the group count in step with s.
    for (int p = 0; p < NS - 1; ++p) {
      if (p < n_steps) stage(p, p);
      cp_async_commit();
    }
    for (int s = 0; s < n_steps; ++s) {
      const int buf = s % NS;
      cp_async_wait<NS - 2>();
      __syncthreads();  // step s has landed; step s - 1 is consumed, so its stage is free
      if (s + NS - 1 < n_steps) stage(s + NS - 1, (s + NS - 1) % NS);
      cp_async_commit();
      int depth;  // K values of this step
      bool mine = true;
      if (!packed) {
        depth = min(KC, c_in - (s % n_chunks) * KC);
        mine = (mask_s[list_s[z + (s / n_chunks) * split]] >> warp) & 1;
      } else {
        depth = min(KC, ktot - (z + s * split) * KC);
      }
      if (mine) {
        const bf16* a_b = a_s + buf * TV * ALD;
        const bf16* w_b = w_s + buf * KC * WLD;
        constexpr int GRP = NC / 16 < 4 ? NC / 16 : 4;  // B fragments loaded ahead of their products
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          if (ks * 16 >= depth) break;
          uint32_t a[4];
          ldmatrix_x4(a, a_b + (warp * 16 + (lane & 15)) * ALD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np0 = 0; np0 < NC / 16; np0 += GRP) {
            uint32_t bw[GRP][4];
#pragma unroll
            for (int i = 0; i < GRP; ++i)
              ldmatrix_x4_trans(bw[i], w_b + (ks * 16 + (quad & 1) * 8 + (lane & 7)) * WLD + (np0 + i) * 16 + (quad >> 1) * 8);
#pragma unroll
            for (int i = 0; i < GRP; ++i) {
              mma_16816(acc[2 * (np0 + i)], a, bw[i][0], bw[i][1]);
              mma_16816(acc[2 * (np0 + i) + 1], a, bw[i][2], bw[i][3]);
            }
          }
        }
      }
    }
  }

  if (split > 1) {
    // this block's partial sums in fp32; `sparse_conv_reduce_kernel` adds the
    // shares, the bias and the cast. A tile with no live row writes nothing.
    if (!tile_live) return;
    const bool pair2 = (c_out & 1) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = v0 + warp * 16 + g + 8 * r;
      if (v >= v_out) continue;
      float* p_row = part + (((size_t)z * (gridDim.z / split) + b) * v_out + v) * c_out;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        if (n >= c_out) continue;
        if (pair2) {
          *reinterpret_cast<float2*>(p_row + n) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        } else {
          p_row[n] = acc[j][2 * r];
          if (n + 1 < c_out) p_row[n + 1] = acc[j][2 * r + 1];
        }
      }
    }
    return;
  }

  // epilogue: bias, zero invalid rows, store in the feature dtype; a thread
  // holds rows g (e 0, 1) and g + 8 (e 2, 3), columns 8 j + 2 t, + 1
  const bool pair = (c_out & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int v = v0 + warp * 16 + g + 8 * r;
    if (v >= v_out) continue;
    const bool live = tile_live && (valid_b == nullptr || valid_b[v]);
    bf16* out_row = out + ((size_t)b * v_out + v) * c_out;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      if (n >= c_out) continue;
      float x0 = 0.f, x1 = 0.f;
      if (live) {
        x0 = acc[j][2 * r] + (bias ? bias[n] : 0.f);
        x1 = acc[j][2 * r + 1] + ((bias && n + 1 < c_out) ? bias[n + 1] : 0.f);
      }
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(out_row + n) = __floats2bfloat162_rn(x0, x1);
      } else {
        out_row[n] = __float2bfloat16(x0);
        if (n + 1 < c_out) out_row[n + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// out = live row ? sum over the K shares + bias : 0, cast to bf16.
__global__ void __launch_bounds__(256) sparse_conv_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ bias,
    const uint8_t* __restrict__ valid, bf16* __restrict__ out, size_t rows, int c_out, int split) {
  const size_t total = rows * c_out;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / c_out;
    float x = 0.f;
    if (valid == nullptr || valid[row]) {
      for (int zz = 0; zz < split; ++zz) x += part[(size_t)zz * total + i];
      if (bias) x += bias[i - row * c_out];
    }
    out[i] = __float2bfloat16(x);
  }
}

template <int NC, int KC, int NS>
int launch_mma(const void* feats, const void* w, const void* kmap, const void* bias,
               const void* valid, void* out, void* part, int batch, int v_in, int c_in,
               int c_out, int n_taps, int v_out, int packed, int split, cudaStream_t stream) {
  using C = MmaCfg<NC, KC, NS>;
  auto kern = sparse_conv_mma_kernel<NC, KC, NS>;
  const size_t bytes = C::bytes(n_taps);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((v_out + TV - 1) / TV, (c_out + NC - 1) / NC, batch * split);
  kern<<<grid, NT, bytes, stream>>>((const bf16*)feats, (const bf16*)w, (const int*)kmap,
                                    (const float*)bias, (const uint8_t*)valid, (bf16*)out,
                                    (float*)part, v_in, c_in, c_out, n_taps, v_out, packed, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t rows = (size_t)batch * v_out;
  const int blocks = (int)((rows * c_out + 255) / 256 < 1056 ? (rows * c_out + 255) / 256 : 1056);
  sparse_conv_reduce_kernel<<<blocks, 256, 0, stream>>>((const float*)part, (const float*)bias,
                                                  (const uint8_t*)valid, (bf16*)out, rows, c_out,
                                                  split);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs. One block per (64 output voxels) x (64 output
// channels); per tap the rows are gathered in chunks of 32 input channels
// into shared memory and each thread accumulates a 4 x 4 register tile.
// ---------------------------------------------------------------------------

constexpr int FTV = 64;   // output voxels per block
constexpr int FTC = 64;   // output channels per block
constexpr int FTK = 32;   // input channels per staged chunk
constexpr int FNT = 256;  // threads per block (16 x 16, each 4 x 4 outputs)

__global__ void __launch_bounds__(FNT) sparse_conv_fma_kernel(
    const float* __restrict__ feats,      // (B, V_in, C_in)
    const float* __restrict__ w,          // (K, C_in, C_out)
    const int* __restrict__ kmap,     // (B, K, V_out)
    const float* __restrict__ bias,   // (C_out) or null
    const uint8_t* __restrict__ valid,  // (B, V_out) or null
    float* __restrict__ out,              // (B, V_out, C_out)
    int v_in, int c_in, int c_out, int n_taps, int v_out) {
  __shared__ float a_s[FTV][FTK + 1];
  __shared__ float w_s[FTK][FTC];
  __shared__ int idx_s[FTV];

  const int b = blockIdx.z;
  const int v0 = blockIdx.x * FTV;
  const int n0 = blockIdx.y * FTC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group

  const uint8_t* valid_b = valid ? valid + (size_t)b * v_out : nullptr;
  int my_live = 0;
  if (tid < FTV) {
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
    const float* feats_b = feats + (size_t)b * v_in * c_in;
    const int* kmap_b = kmap + (size_t)b * n_taps * v_out;
    for (int k = 0; k < n_taps; ++k) {
      int hit = 0;
      if (tid < FTV) {
        const int v = v0 + tid;
        const int id = (v < v_out) ? kmap_b[(size_t)k * v_out + v] : -1;
        idx_s[tid] = id;
        hit = id >= 0;
      }
      if (!__syncthreads_or(hit)) continue;
      const float* w_k = w + (size_t)k * c_in * c_out;
      for (int c0 = 0; c0 < c_in; c0 += FTK) {
        // gather FTV x FTK input rows (zero for a missing neighbour)
        for (int e = tid; e < FTV * FTK; e += FNT) {
          const int r = e / FTK, c = e % FTK;
          const int id = idx_s[r];
          float val = 0.f;
          if (id >= 0 && c0 + c < c_in) val = (feats_b[(size_t)id * c_in + c0 + c]);
          a_s[r][c] = val;
        }
        // stage W[k][c0:c0+FTK, n0:n0+FTC]
        for (int e = tid; e < FTK * FTC; e += FNT) {
          const int c = e / FTC, n = e % FTC;
          float val = 0.f;
          if (c0 + c < c_in && n0 + n < c_out) val = (w_k[(size_t)(c0 + c) * c_out + n0 + n]);
          w_s[c][n] = val;
        }
        __syncthreads();
        const int kk_end = min(FTK, c_in - c0);
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
    float* out_row = out + ((size_t)b * v_out + v) * c_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= c_out) continue;
      float r = 0.f;
      if (live) r = acc[i][j] + (bias ? bias[n] : 0.f);
      out_row[n] = r;
    }
  }
}


}  // namespace

extern "C" int xm_sparse_conv_f32(const void* feats, const void* w, const void* kmap,
                                  const void* bias, const void* valid, void* out,
                                  int batch, int v_in, int c_in, int c_out,
                                  int n_taps, int v_out, void* stream) {
  if (v_out > 0 && c_out > 0 && batch > 0) {
    dim3 grid((v_out + FTV - 1) / FTV, (c_out + FTC - 1) / FTC, batch);
    sparse_conv_fma_kernel<<<grid, FNT, 0, (cudaStream_t)stream>>>(
        (const float*)feats, (const float*)w, (const int*)kmap, (const float*)bias,
        (const uint8_t*)valid, (float*)out, v_in, c_in, c_out, n_taps, v_out);
  }
  return (int)cudaGetLastError();
}

// nc: output channels a block holds (32, 64, 128 or 256); kc: K values a
// staged chunk (32 in a ring of four stages, 64 in a ring of three); packed:
// taps and channels as one K dimension with scalar staging (widths or
// pointers off 16 bytes); split: blocks that share a tile's K dimension,
// with `part` their fp32 scratch. The wrapper chooses all four (`kernel_plan`
// in ops/sparse_conv.py).
extern "C" int xm_sparse_conv_bf16(const void* feats, const void* w, const void* kmap,
                                   const void* bias, const void* valid, void* out, void* part,
                                   int batch, int v_in, int c_in, int c_out,
                                   int n_taps, int v_out, int nc, int kc, int packed, int split,
                                   void* stream) {
  if (v_out <= 0 || c_out <= 0 || batch <= 0) return 0;
  if (split < 1 || (split > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define XM_K1(NC)                                                                           \
  case NC:                                                                                  \
    if (kc == 64)                                                                           \
      return launch_mma<NC, 64, 3>(feats, w, kmap, bias, valid, out, part, batch, v_in,     \
                                   c_in, c_out, n_taps, v_out, packed, split, s);           \
    if (kc == 32)                                                                           \
      return launch_mma<NC, 32, 4>(feats, w, kmap, bias, valid, out, part, batch, v_in,     \
                                   c_in, c_out, n_taps, v_out, packed, split, s);           \
    break
  switch (nc) {
    XM_K1(32);
    XM_K1(64);
    XM_K1(128);
    XM_K1(256);
  }
#undef XM_K1
  return (int)cudaErrorInvalidValue;
}
