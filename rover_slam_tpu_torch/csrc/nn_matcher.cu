// Fused masked nearest-neighbour descriptor reduce, for Hopper (sm_90a).
//
// Replaces the TPU kernel rover_slam_tpu/ops/pallas_matcher.py::_nn_kernel
// (called through nn_reduce and mutual_nn_match_pallas). For each row of
// desc0 it returns, over the valid columns of desc1, the best L2^2 distance
// (2 - 2 cos of unit descriptors), its argmin (the first index wins ties) and
// the second best (the minimum of the losers). Invalid columns score 1e9.
//
// What bounds it on this card: at the path's shapes (1024 x 1024 x 256) one
// call reads ~1 MB and does ~0.5 GFLOP, a few microseconds at either roofline;
// the [N0, N1] score matrix is what the fused form keeps out of device memory
// (4 MB at N = 1024, 1 GB at the 16k-keypoint scale). This first version runs
// the products on the CUDA cores (bf16 inputs widened to f32, f32 sums), so
// it is bounded by f32 FMA issue and by the 16 blocks a 1024-row call makes.
//
// Design: one block per 64-row tile of desc0; a loop inside the block runs
// over all of desc1 in 64-column tiles, which replaces the TPU's j-axis carry
// in VMEM. Each of the 256 threads owns a 4x4 piece of the 64x64 score tile,
// the depth is staged through shared memory in 32-wide chunks, and each
// row's best / argmin / second best stay in registers across column tiles,
// merged with the same rule as the TPU kernel (strict < keeps the earlier
// index). Rows are independent, so there are no atomics and no second pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;    // desc0 rows per block
constexpr int TN = 64;    // desc1 columns per tile
constexpr int DK = 32;    // depth chunk staged in shared memory
constexpr int THREADS = 256;
constexpr float BIG = 1e9f;

// Merge a (best, arg, second) triple from columns that may come before or
// after ours; ties on the best value go to the lower column index.
__device__ __forceinline__ void merge(float& b, int& a, float& s, float ob,
                                      int oa, float os) {
  if (ob < b || (ob == b && oa < a)) {
    s = fminf(fminf(s, os), b);
    b = ob;
    a = oa;
  } else {
    s = fminf(fminf(s, os), ob);
  }
}

__global__ void __launch_bounds__(THREADS)
nn_kernel(const __nv_bfloat16* __restrict__ d0, const __nv_bfloat16* __restrict__ d1,
          const uint8_t* __restrict__ valid1, float* __restrict__ best_out,
          int* __restrict__ idx_out, float* __restrict__ second_out, int N0,
          int N1, int D) {
  __shared__ float As[DK][TM + 4];
  __shared__ float Bs[DK][TN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // row group: rows ty*4 .. ty*4+3
  const int r0 = blockIdx.x * TM;

  float run_b[4], run_s[4];
  int run_a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run_b[i] = INFINITY;
    run_s[i] = INFINITY;
    run_a[i] = 0;
  }

  for (int c0 = 0; c0 < N1; c0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += DK) {
      __syncthreads();
      for (int e = tid; e < TM * DK; e += THREADS) {
        const int r = e / DK, kq = e % DK, gk = k0 + kq;
        const int gr = r0 + r, gc = c0 + r;
        As[kq][r] = (gr < N0 && gk < D) ? __bfloat162float(d0[(long long)gr * D + gk]) : 0.f;
        Bs[kq][r] = (gc < N1 && gk < D) ? __bfloat162float(d1[(long long)gc * D + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kq = 0; kq < DK; ++kq) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kq][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[kq][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // This thread's four columns, in increasing index order.
      float b = INFINITY, s = INFINITY;
      int a = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        const bool ok = col < N1 && valid1[col];
        const float sc = ok ? 2.f - 2.f * acc[i][j] : BIG;
        if (sc < b) {
          s = b;
          b = sc;
          a = col;
        } else {
          s = fminf(s, sc);
        }
      }
      // Butterfly over the 16 threads of this row group (one half-warp).
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, b, off);
        const int oa = __shfl_xor_sync(0xffffffffu, a, off);
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        merge(b, a, s, ob, oa, os);
      }
      // The running state holds earlier (lower-index) columns: merge it in
      // with the TPU kernel's rule.
      if (b < run_b[i]) {
        run_s[i] = fminf(fminf(run_s[i], s), run_b[i]);
        run_b[i] = b;
        run_a[i] = a;
      } else {
        run_s[i] = fminf(fminf(run_s[i], s), b);
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r < N0) {
        best_out[r] = run_b[i];
        idx_out[r] = run_a[i];
        second_out[r] = run_s[i];
      }
    }
  }
}

}  // namespace

// desc0 [N0, D] and desc1 [N1, D] bf16 row-major, valid1 [N1] bytes;
// outputs best f32 [N0], idx int32 [N0], second f32 [N0].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int nn_reduce(const void* desc0, const void* desc1,
                         const void* valid1, void* best, void* idx,
                         void* second, int N0, int N1, int D, void* stream) {
  const int blocks = (N0 + TM - 1) / TM;
  nn_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)desc0, (const __nv_bfloat16*)desc1,
      (const uint8_t*)valid1, (float*)best, (int*)idx, (float*)second, N0,
      N1, D);
  return (int)cudaGetLastError();
}
