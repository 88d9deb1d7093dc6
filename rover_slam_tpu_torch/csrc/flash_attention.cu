// Masked flash attention for the LightGlue transformer, for Hopper (sm_90a).
//
// Replaces the TPU kernel rover_slam_tpu/ops/pallas_attention.py::_flash_kernel
// (called through masked_attention). Computes
//     out = softmax(q k^T, masked over kv) v
// with q already divided by sqrt(Dh) by the caller, masked kv logits set to
// -1e9 and kv rows at or beyond Nk set to -inf. A row whose real kv is all
// masked therefore returns the mean of v over Nk, as the XLA path of the JAX
// package does. Inputs are read through strides of the [B, N, H, Dh] layout,
// so no transpose copy is made.
//
// Two routes:
//  - bf16 (the main path): flash_tc_kernel, FA2-style on the tensor cores.
//  - f32 (tests only): flash_kernel, the first CUDA-core version, unchanged.
//
// What bounds it on this card: at the path's shapes (B <= 3, N = 1024, H = 4,
// Dh = 64; B = 3 only in relocalization) one call reads ~1.5-4.5 MB and does
// ~1-3 GFLOP, about 1-3 us at the tensor-core peak. The call is far too small
// for that: B * H * N / 16 = 256 warp-sized row groups at B = 1, so latency
// (each warp's chain of mma.sync, exp2 and shared-memory loads per kv tile)
// and occupancy set the pace, not the tensor-core rate. That is also why it
// uses mma.sync and not wgmma: a 64-row warpgroup tile would quarter the
// number of blocks. The time grows about linearly with B (PERF.md).
//
// Design of the bf16 route: a block owns 32 query rows of one (batch, head),
// so B = 1, N = 1024 makes 128 blocks. Its four warps are two row groups of
// 16 rows times two kv halves: each 64-key tile is split between two warps,
// which run their own online softmax over their keys and are merged through
// shared memory at the end. A loop over all kv tiles takes the place of the
// TPU's sequential third grid axis. Q is staged once through shared memory
// and held as mma A fragments in registers (ldmatrix). K and V tiles are
// copied with cp.async into a two-slot ring, so tile t+1 is in flight while
// tile t is computed; rows are padded by 16 bytes so that ldmatrix reads
// eight different bank groups. Every key's mask code is read into shared
// memory once at the start (a byte load per key inside the loop stalled each
// tile on a global load). S = Q K^T is one m16n8k16 mma per 8 keys and 16
// head dims; the mask is applied to the f32 accumulators; the online softmax
// keeps its running max and sum per row in registers, with max reductions
// over the four lanes of a quad by shuffles and one exp2 per score (log2 e
// folded in). P goes from the S fragments in registers straight into the A
// operand of O += P V (V through ldmatrix.trans).
//
// Deliberate departure from the TPU kernel's arithmetic: P goes in as two
// bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so it keeps ~16
// significant bits. The TPU kernel (pallas_attention.py:54) and the plain
// version round P to bf16 once. With one rounding, the full-width path A's
// trajectory error read over 5 cm in most runs (two terms: in few). The JAX
// package itself reads over 5 cm there at the single rounding, so that
// sensitivity is the reference's own (ROADMAP.md section C, readings in
// PERF.md). The second term costs about a fifth of the kernel time. FLASH_P_TERMS=1 builds the TPU's single
// rounding (profile_port.py --ate-spread measures both).
#ifndef FLASH_P_TERMS
#define FLASH_P_TERMS 2
#endif
static_assert(FLASH_P_TERMS == 1 || FLASH_P_TERMS == 2, "FLASH_P_TERMS is 1 or 2");

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_sm90.cuh"

namespace {

constexpr int TQ = 64;      // query rows per block
constexpr int TK = 64;      // kv rows per tile
constexpr int PARTS = 4;    // threads per query row
constexpr int THREADS = TQ * PARTS;
constexpr float NEG = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// f32 route: the first version of this kernel, products on the CUDA cores.
// One block per (batch*head, 64-row query tile); four threads share one query
// row, each owning every fourth head dimension; q.k partial dots are summed
// with two warp shuffles.
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

// ---- bf16 route: tensor cores ----------------------------------------------

constexpr int TC_ROWG = 2;                  // 16-row query groups per block
constexpr int TC_KVS = 2;                   // warps sharing one row group's kv tiles
constexpr int TC_THREADS = 32 * TC_ROWG * TC_KVS;
constexpr int TC_BQ = 16 * TC_ROWG;         // query rows per block
constexpr int TC_BK = 64;                   // keys per kv tile
constexpr int TC_KW = TC_BK / TC_KVS;       // keys of a tile that one warp takes
constexpr int TC_STAGES = 2;                // kv tiles in flight (ring buffer)
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TC_KW % 16 == 0 && TC_THREADS >= TC_BK, "tile split");

// Dynamic shared memory of flash_tc_kernel<DH>: the Q tile, then K and V
// rings of TC_STAGES tiles (rows padded to DH + 8), then one mask code per
// key, for all Nk keys rounded up to whole tiles.
template <int DH>
int tc_smem_bytes(int Nk) {
  return (TC_BQ + 2 * TC_STAGES * TC_BK) * (DH + 8) * 2 +
         (Nk + TC_BK - 1) / TC_BK * TC_BK;
}

// Mask code of key kj: 0 = valid, 1 = masked (-1e9), 2 = beyond Nk (-inf).
__device__ __forceinline__ uint8_t mask_code(const uint8_t* mb, int kj, int Nk) {
  return kj < Nk ? (mb[kj] ? 0 : 1) : 2;
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                __nv_bfloat16* __restrict__ out, int H, int Nq, int Nk,
                long long sqb, long long sqn, long long sqh,
                long long skb, long long skn, long long skh,
                long long svb, long long svn, long long svh,
                long long smb, long long sob, long long son, long long soh) {
  constexpr int LD = DH + 8;     // padded shared-memory row, in elements
  constexpr int CH = DH / 8;     // 16-byte chunks per row
  constexpr int KD = DH / 16;    // k-steps of Q K^T
  constexpr int NT = TC_KW / 8;  // 8-key score tiles of one warp per kv tile
  constexpr int DT = DH / 8;     // 8-dim output tiles
  constexpr int RED = 4 + 4 * DT;  // floats per lane in the final merge
  constexpr int TILE = TC_BK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + TC_BQ * LD;          // [stage][key][LD]; both rings
  __nv_bfloat16* vs = ks + TC_STAGES * TILE;    // are reused for the final merge
  uint8_t* mk = reinterpret_cast<uint8_t*>(vs + TC_STAGES * TILE);   // [key]
  static_assert(TC_ROWG * (TC_KVS - 1) * RED * 32 * 4 <= 2 * TC_STAGES * TILE * 2,
                "merge space");

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * TC_BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = warp % TC_ROWG, split = warp / TC_ROWG;
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row of this lane

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;
  const uint8_t* mb = mask + b * smb;

  for (int e = tid; e < TC_BQ * CH; e += TC_THREADS) {
    const int i = e / CH, c = e % CH, qi = q0 + i;
    const bool ok = qi < Nq;
    tc::cp_async16(&qs[i * LD + c * 8], qb + (long long)(ok ? qi : 0) * sqn + c * 8, ok);
  }
  const int T = (Nk + TC_BK - 1) / TC_BK;
  // Tile `tile` into ring slot tile % TC_STAGES (nothing past the last tile;
  // the commit still makes one group, so the wait counts stay uniform).
  auto load_kv = [&](int tile) {
    if (tile < T) {
      const int k0 = tile * TC_BK, slot = tile % TC_STAGES;
      for (int e = tid; e < TC_BK * CH; e += TC_THREADS) {
        const int j = e / CH, c = e % CH, kj = k0 + j;
        const bool ok = kj < Nk;
        const long long row = ok ? kj : 0;
        tc::cp_async16(&ks[slot * TILE + j * LD + c * 8], kb + row * skn + c * 8, ok);
        tc::cp_async16(&vs[slot * TILE + j * LD + c * 8], vb + row * svn + c * 8, ok);
      }
    }
    tc::cp_async_commit();
  };
  for (int i = 0; i < TC_STAGES - 1; ++i) load_kv(i);
  // Every key's mask code, read once while the first tiles are in flight.
  for (int e = tid; e < T * TC_BK; e += TC_THREADS) mk[e] = mask_code(mb, e, Nk);

  uint32_t qf[KD][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // Rows g and g + 8 of this warp's 16, over this warp's half of the keys:
  // running max and this lane's part of the running sum.
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < T; ++t) {
    const int slot = t % TC_STAGES;
    const int ahead = t + TC_STAGES - 1;   // the tile whose copy starts now
    load_kv(ahead);
    tc::cp_async_wait<TC_STAGES - 1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldsm_x4(qf[kk], &qs[(rg * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8]);
    }

    // S = Q K^T for this warp's 16 rows and its TC_KW keys of the tile.
    const __nv_bfloat16* K = ks + slot * TILE + split * TC_KW * LD;
    const uint8_t* mt = mk + t * TC_BK + split * TC_KW;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        tc::ldsm_x4(kf, &K[(np * 16 + mr + (mat >> 1) * 8) * LD + kk * 16 + (mat & 1) * 8]);
        tc::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Mask, then the online softmax on the accumulator fragments.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint8_t code = mt[j * 8 + t4 * 2 + (e & 1)];
        const float x = code == 0 ? s[j][e] : (code == 1 ? NEG : -INFINITY);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f((m_run[r] - m_new) * LOG2E);
      m_run[r] = m_new;
      m2[r] = m_new * LOG2E;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], LOG2E, -m2[e >> 1]));
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V, P straight from the S fragments as FLASH_P_TERMS bf16 terms
    // (hi = bf16(p), lo = bf16(p - hi)).
    const __nv_bfloat16* V = vs + slot * TILE + split * TC_KW * LD;
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      uint32_t ph[4], pl[4];
      tc::split_bf16(s[2 * c][0], s[2 * c][1], ph[0], pl[0]);
      tc::split_bf16(s[2 * c][2], s[2 * c][3], ph[1], pl[1]);
      tc::split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], ph[2], pl[2]);
      tc::split_bf16(s[2 * c + 1][2], s[2 * c + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        tc::ldsm_x4_trans(vf, &V[(c * 16 + mr + (mat & 1) * 8) * LD + dp * 16 + (mat >> 1) * 8]);
        tc::mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
        tc::mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        if (FLASH_P_TERMS == 2) {
          tc::mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
          tc::mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
        }
      }
    }

    __syncthreads();   // slot `slot` is refilled by the next iteration
  }
  tc::cp_async_wait<0>();

  // Merge the kv splits of each row group (same fragment layout in every
  // warp): splits 1.. leave (m, l, o) in shared memory, split 0 folds them in.
  float* red = reinterpret_cast<float*>(ks);
  if (split > 0) {
    float* dst = red + (rg * (TC_KVS - 1) + split - 1) * RED * 32 + lane;
    dst[0] = m_run[0];
    dst[32] = m_run[1];
    dst[64] = l_run[0];
    dst[96] = l_run[1];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(4 + d * 4 + e) * 32] = o[d][e];
  }
  __syncthreads();
  if (split > 0) return;
#pragma unroll
  for (int sp = 1; sp < TC_KVS; ++sp) {
    const float* src = red + (rg * (TC_KVS - 1) + sp - 1) * RED * 32 + lane;
    float a_self[2], a_other[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_o = src[r * 32];
      const float m_new = fmaxf(m_run[r], m_o);
      a_self[r] = exp2f((m_run[r] - m_new) * LOG2E);
      a_other[r] = exp2f((m_o - m_new) * LOG2E);
      m_run[r] = m_new;
      l_run[r] = l_run[r] * a_self[r] + src[(2 + r) * 32] * a_other[r];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[d][e] = o[d][e] * a_self[e >> 1] + src[(4 + d * 4 + e) * 32] * a_other[e >> 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    const int qi = q0 + rg * 16 + g + 8 * r;
    if (qi < Nq) {
      __nv_bfloat16* op = out + b * sob + (long long)qi * son + h * soh;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(op + d * 8 + t4 * 2) =
            __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* mask,
                void* out, int B, int H, int Nq, int Nk, const long long* st,
                cudaStream_t stream) {
  dim3 grid(B * H, (Nq + TQ - 1) / TQ);
  flash_kernel<float, DH><<<grid, THREADS, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const uint8_t*)mask,
      (float*)out, H, Nq, Nk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12]);
  return cudaSuccess;
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* mask,
                 void* out, int B, int H, int Nq, int Nk, const long long* st,
                 cudaStream_t stream) {
  const int smem = tc_smem_bytes<DH>(Nk);
  // The opt-in holds per device, so it is set on every launch that needs it.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B * H, (Nq + TC_BQ - 1) / TC_BQ);
  flash_tc_kernel<DH><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const uint8_t*)mask, (__nv_bfloat16*)out, H, Nq, Nk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12]);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (in elements): q b/n/h, k b/n/h,
// v b/n/h, mask b, out b/n/h; the head dimension is contiguous everywhere.
// The bf16 route copies 16-byte pieces: q, k, v must be 16-byte aligned with
// b/n/h strides that are multiples of 8 (the wrapper sees to it).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int dtype, int B,
                               int H, int Nq, int Nk, int Dh,
                               const long long* strides, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 1 && Dh == 64) err = launch_bf16<64>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else if (dtype == 1 && Dh == 32) err = launch_bf16<32>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else if (dtype == 0 && Dh == 64) err = launch_f32<64>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else if (dtype == 0 && Dh == 32) err = launch_f32<32>(q, k, v, mask, out, B, H, Nq, Nk, strides, s);
  else return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
