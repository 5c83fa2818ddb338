// Hopper building blocks shared by the tensor-core kernels: 16-byte
// asynchronous copies into shared memory (cp.async, zero-filling with a source
// size of 0), ldmatrix fragment loads and the bf16 mma.sync m16n8k16 product
// with fp32 accumulators.
//
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0: (row g, k 2t..2t+1)   a1: (row g+8, same k)
//                           a2: (row g, k 2t+8..)     a3: (row g+8, k 2t+8..)
//   B (16 x 8, "col")       b0: (k 2t..2t+1, n g)     b1: (k 2t+8.., n g)
//   C/D (16 x 8, fp32)      c0, c1: (row g, n 2t, 2t+1)   c2, c3: (row g+8, same n)
// ldmatrix_x4 on rows of [row][k] storage gives A (lanes 0-15 address rows
// 0-15 at k 0-7, lanes 16-31 the same rows at k 8-15) or, on [n][k] storage,
// B for two n-tiles; ldmatrix_x4_trans on [k][n] storage gives B for two
// n-tiles (b0, b1 of the first, then of the second).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace xm {

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm(  // a pure function of its registers: the compiler may move it between the loads
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace xm
