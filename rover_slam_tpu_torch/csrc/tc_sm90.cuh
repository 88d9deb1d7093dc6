// Warp-level tensor-core and async-copy helpers shared by the port's kernels
// (flash_attention.cu, nn_matcher.cu), for Hopper (sm_90a).
//
// Fragment layouts are those of mma.sync.m16n8k16 with bf16 inputs and f32
// accumulators. For a lane, g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, k-major):    b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16x8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column tiles are, rounded to
// bf16 and packed in pairs, the A fragment of a 16-deep product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; writes zeros when !pred
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b (16x8x16, bf16 in, f32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two floats -> their bf16 pair (hi) and the bf16 pair of what rounding
// left (lo), so hi + lo carries ~16 significant bits of each.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

}  // namespace tc
