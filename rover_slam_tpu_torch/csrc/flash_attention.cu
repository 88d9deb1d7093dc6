// Masked flash attention for the LightGlue transformer, for Hopper (sm_90a).
//
// Replaces the TPU kernel rover_slam_tpu/ops/pallas_attention.py::_flash_kernel
// (called through masked_attention). Computes
//     out = softmax(q k^T, masked over kv) v
// with q already divided by sqrt(Dh) by the caller, masked kv logits set to
// -1e9 and kv rows at or beyond Nk skipped by bounds.
//
// What bounds it on this card: at the path's shapes (B <= 2, N = 1024, H = 4,
// Dh = 64) one call reads ~1.5 MB and does ~0.5-1 GFLOP, so the roofline is
// the tensor-core rate (~1 us) and the real limit is latency and occupancy:
// this first version runs its products on the CUDA cores in f32.
//
// Design: one block per (batch*head, 64-row query tile); a loop inside the
// block over 64-row kv tiles takes the place of the TPU's sequential third
// grid axis, with the running max, running sum and accumulator in f32
// registers (online softmax), so the [Nq, Nk] logits never reach device
// memory. Four threads share one query row, each owning every fourth head
// dimension (interleaved so the four read four consecutive shared-memory
// banks); q.k partial dots are summed with two warp shuffles. Inputs are read
// through strides of the [B, N, H, Dh] layout, so no transpose copy is made.
// A row whose real kv is all masked returns the mean of v over Nk, as the
// XLA path of the JAX package does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;      // query rows per block
constexpr int TK = 64;      // kv rows per tile
constexpr int PARTS = 4;    // threads per query row
constexpr int THREADS = TQ * PARTS;
constexpr float NEG = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const uint8_t* __restrict__ mask,
             T* __restrict__ out, int H, int Nq, int Nk,
             long long sqb, long long sqn, long long sqh,
             long long skb, long long skn, long long skh,
             long long svb, long long svn, long long svh,
             long long smb, long long sob, long long son, long long soh) {
  constexpr int DP = DH / PARTS;
  __shared__ float ks[TK][DH + 1];
  __shared__ float vs[TK][DH + 1];
  __shared__ float mk[TK];   // 1 = valid, 0 = masked, -1 = beyond Nk

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int row = tid / PARTS;
  const int part = tid % PARTS;
  const int qi = blockIdx.y * TQ + row;
  const int qc = qi < Nq ? qi : Nq - 1;

  float qr[DP], acc[DP];
  const T* qp = q + b * sqb + (long long)qc * sqn + h * sqh;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = to_f(qp[d * PARTS + part]);
    acc[d] = 0.f;
  }
  float m_run = -1e30f, l_run = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += TK) {
    __syncthreads();
    for (int e = tid; e < TK * DH; e += THREADS) {
      const int j = e / DH, d = e % DH, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Nk) {
        kv = to_f(k[b * skb + (long long)kj * skn + h * skh + d]);
        vv = to_f(v[b * svb + (long long)kj * svn + h * svh + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (tid < TK) {
      const int kj = k0 + tid;
      mk[tid] = kj < Nk ? (mask[b * smb + kj] ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

    float s[TK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], ks[j][d * PARTS + part], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const float m = mk[j];
      const float sj = m > 0.5f ? dot : (m > -0.5f ? NEG : -INFINITY);
      s[j] = sj;
      tmax = fmaxf(tmax, sj);
    }
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= alpha;
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const float p = expf(s[j] - m_new);
      lsum += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, vs[j][d * PARTS + part], acc[d]);
    }
    l_run = l_run * alpha + lsum;
    m_run = m_new;
  }

  if (qi < Nq) {
    const float inv = 1.f / fmaxf(l_run, 1e-20f);
    T* op = out + b * sob + (long long)qi * son + h * soh;
#pragma unroll
    for (int d = 0; d < DP; ++d) op[d * PARTS + part] = from_f<T>(acc[d] * inv);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* out, int B, int H, int Nq, int Nk, const long long* st,
            cudaStream_t stream) {
  dim3 grid(B * H, (Nq + TQ - 1) / TQ);
  flash_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)mask, (T*)out,
      H, Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (in elements): q b/n/h, k b/n/h,
// v b/n/h, mask b, out b/n/h; the head dimension is contiguous everywhere.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int dtype, int B,
                               int H, int Nq, int Nk, int Dh,
                               const long long* strides, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && Dh == 64) launch<__nv_bfloat16, 64>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else if (dtype == 1 && Dh == 32) launch<__nv_bfloat16, 32>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else if (dtype == 0 && Dh == 64) launch<float, 64>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else if (dtype == 0 && Dh == 32) launch<float, 32>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
