// Fused masked nearest-neighbour descriptor reduce, for Hopper (sm_90a).
//
// Replaces the TPU kernel rover_slam_tpu/ops/pallas_matcher.py::_nn_kernel
// (called through nn_reduce and mutual_nn_match_pallas). For each row of
// desc0 it returns, over the valid columns of desc1, the best L2^2 distance
// (2 - 2 cos of unit descriptors), its argmin (the first index wins ties) and
// the second best (the minimum of the losers). Invalid columns score 1e9.
//
// What bounds it on this card: at the path's shapes (1024 x 1024 x 256) one
// call reads ~1 MB and does ~0.5 GFLOP, about 0.5 us at either roofline; the
// [N0, N1] score matrix is what the fused form keeps out of device memory
// (4 MB at N = 1024, 1 GB at the 16k-keypoint scale). A call this small is
// bounded by latency and by how many SMs it keeps busy, so the design spreads
// it over at least 128 blocks and puts the products on the tensor cores.
//
// Design: the grid is (row tiles of 64 rows) x (column splits). A block holds
// its 64 rows of desc0 in shared memory for all its columns and walks its
// split of desc1 in 64-column tiles, copied with cp.async into two buffers
// so the next tile's copy overlaps the current tile's products; valid1 of the
// next tile is prefetched into a register and stored to shared memory after
// the current tile. Each of the four warps computes a 16 x 64 score tile with
// mma.sync m16n8k16 (bf16 in, f32 sums), reduces it per row to (best, arg,
// second) in registers (a scan in column order, then a butterfly over the
// four lanes of a quad) and folds it into its running triple. Each block
// writes one partial triple per row for its split into scratch [S, N0]; a
// second small kernel merges the S partials of a row in column order with the
// TPU kernel's rule (strict < keeps the earlier index, second = min of the
// losers). No atomics, so every run gives the same bits. One reduce is always
// these two launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_sm90.cuh"

namespace {

constexpr int TM = 64;    // desc0 rows per block (four warps of 16)
constexpr int TN = 64;    // desc1 columns per tile
constexpr int THREADS = 128;
constexpr float BIG = 1e9f;

// Merge a (best, arg, second) triple from columns that may come before or
// after ours; ties on the best value go to the lower column index, so a
// merge of later columns into earlier ones is the TPU kernel's rule across
// its column grid axis (strict < keeps the earlier index).
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
nn_tc_kernel(const __nv_bfloat16* __restrict__ d0, const __nv_bfloat16* __restrict__ d1,
             const uint8_t* __restrict__ valid1, float* __restrict__ best_out,
             int* __restrict__ idx_out, float* __restrict__ second_out, int N0,
             int N1, int D, int split_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LD = D + 8;   // padded row (elements): ldmatrix rows hit distinct banks
  const int CH = D / 8;   // 16-byte chunks per row
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [TM][LD]
  __nv_bfloat16* Bs = As + TM * LD;                              // [2][TN][LD]
  uint8_t* vk = reinterpret_cast<uint8_t*>(Bs + 2 * TN * LD);    // [2][TN]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const int r0 = blockIdx.x * TM;
  const int split = blockIdx.y;
  const int c_begin = split * split_cols;
  const int c_end = min(N1, c_begin + split_cols);
  const int T = (c_end - c_begin + TN - 1) / TN;

  for (int e = tid; e < TM * CH; e += THREADS) {
    const int i = e / CH, c = e % CH, gr = r0 + i;
    const bool ok = gr < N0;
    tc::cp_async16(&As[i * LD + c * 8], d0 + (long long)(ok ? gr : 0) * D + c * 8, ok);
  }
  auto load_b = [&](int tile, int buf) {
    const int c0 = c_begin + tile * TN;
    for (int e = tid; e < TN * CH; e += THREADS) {
      const int j = e / CH, c = e % CH, gc = c0 + j;
      const bool ok = gc < c_end;
      tc::cp_async16(&Bs[(buf * TN + j) * LD + c * 8],
                     d1 + (long long)(ok ? gc : 0) * D + c * 8, ok);
    }
  };
  auto valid_code = [&](int gc) -> uint8_t { return gc < c_end && valid1[gc] ? 1 : 0; };
  load_b(0, 0);
  tc::cp_async_commit();
  if (tid < TN) vk[tid] = valid_code(c_begin + tid);

  // Rows g and g + 8 of this warp's 16: the running triple over the columns
  // seen so far (identical in the four lanes of a quad).
  float rb[2] = {INFINITY, INFINITY}, rs[2] = {INFINITY, INFINITY};
  int ra[2] = {0, 0};

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    uint8_t vnext = 0;
    if (t + 1 < T) {
      load_b(t + 1, buf ^ 1);
      tc::cp_async_commit();
      if (tid < TN) vnext = valid_code(c_begin + (t + 1) * TN + tid);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* Bt = Bs + buf * TN * LD;
    float acc[TN / 8][4];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      tc::ldsm_x4(af, &As[(warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < TN / 16; ++np) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, &Bt[(np * 16 + mr + (mat >> 1) * 8) * LD + kk * 16 + (mat & 1) * 8]);
        tc::mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    const int c0 = c_begin + t * TN;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // This lane's 16 columns, in increasing index order.
      float b = INFINITY, s = INFINITY;
      int a = 0;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + t4 * 2 + e;
          const float sc = vk[buf * TN + col] ? 2.f - 2.f * acc[j][2 * r + e] : BIG;
          if (sc < b) {
            s = b;
            b = sc;
            a = c0 + col;
          } else {
            s = fminf(s, sc);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, b, off);
        const int oa = __shfl_xor_sync(0xffffffffu, a, off);
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        merge(b, a, s, ob, oa, os);
      }
      merge(rb[r], ra[r], rs[r], b, a, s);
    }

    if (t + 1 < T && tid < TN) vk[(buf ^ 1) * TN + tid] = vnext;
    __syncthreads();   // buffer `buf` is refilled by the next iteration
  }

  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + warp * 16 + g + 8 * r;
      if (row < N0) {
        const long long o = (long long)split * N0 + row;
        best_out[o] = rb[r];
        idx_out[o] = ra[r];
        second_out[o] = rs[r];
      }
    }
  }
}

// Merge the S column-split partials [S, N0] of each row, in column order.
__global__ void nn_merge_kernel(const float* __restrict__ pbest, const int* __restrict__ pidx,
                                const float* __restrict__ psecond, int S, int N0,
                                float* __restrict__ best, int* __restrict__ idx,
                                float* __restrict__ second) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N0) return;
  float b = pbest[r], s = psecond[r];
  int a = pidx[r];
  for (int k = 1; k < S; ++k) {
    const long long o = (long long)k * N0 + r;
    merge(b, a, s, pbest[o], pidx[o], psecond[o]);
  }
  best[r] = b;
  idx[r] = a;
  second[r] = s;
}

// Shared memory one block of nn_tc_kernel needs at depth D (0 if D is refused).
int smem_bytes(int D) {
  if (D <= 0 || D % 16 != 0) return 0;
  return (TM + 2 * TN) * (D + 8) * 2 + 2 * TN;
}

}  // namespace

// desc0 [N0, D] and desc1 [N1, D] bf16 row-major and 16-byte aligned, D a
// multiple of 16; valid1 [N1] bytes; outputs best f32 [N0], idx int32 [N0],
// second f32 [N0]. The column axis is cut into S = ceil(N1 / split_cols)
// splits (split_cols a multiple of 64); the scratch partials pbest f32 /
// pidx int32 / psecond f32, each [S, N0], are written by the first kernel and
// merged by a second one (two launches for one reduce). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int nn_reduce(const void* desc0, const void* desc1, const void* valid1,
                         void* best, void* idx, void* second, void* pbest,
                         void* pidx, void* psecond, int N0, int N1, int D,
                         int split_cols, void* stream) {
  const int smem = smem_bytes(D);
  if (smem == 0 || split_cols <= 0 || split_cols % TN != 0) return (int)cudaErrorInvalidValue;
  // The opt-in holds per device, so it is set on every launch that needs it.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nn_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int S = (N1 + split_cols - 1) / split_cols;
  dim3 grid((N0 + TM - 1) / TM, S);
  nn_tc_kernel<<<grid, THREADS, smem, s>>>(
      (const __nv_bfloat16*)desc0, (const __nv_bfloat16*)desc1, (const uint8_t*)valid1,
      (float*)pbest, (int*)pidx, (float*)psecond, N0, N1, D, split_cols);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_merge_kernel<<<(N0 + 255) / 256, 256, 0, s>>>(
      (const float*)pbest, (const int*)pidx, (const float*)psecond, S, N0,
      (float*)best, (int*)idx, (float*)second);
  return (int)cudaGetLastError();
}
