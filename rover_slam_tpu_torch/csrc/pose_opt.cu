// Motion-only pose optimization, a whole `pose_optimization` call in one
// launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's rover_slam_tpu/optim/pose_opt.py
// is one XLA program (a lax.fori_loop over rounds and iterations). The
// port's plain version, optim/pose_opt.py::pose_optimization_plain, runs the
// same loop as ~300 eager launches an iteration and two host syncs (the SVD
// and det of lie.normalize_rotation); on the tracker's path that is 22
// iterations a call, two calls a frame.
//
// What bounds it on this card: at M = 1024 edges one call reads ~35 KB and
// does ~7 MFLOP over its 22 iterations, both negligible. The kernel is bound
// by its serial chain: each Gauss-Newton iteration is a reduction of the 27
// normal-equation sums over the block, then one 6x6 solve, an exponential
// map and a 3x3 polar factor on one thread, then a broadcast of the pose. So
// the design is one block (grid 1) of 512 threads with two block barriers an
// iteration (four with the cost test), the edge data read once into
// registers (2 edges a thread up to M = 1024; above that the same arithmetic
// walks the edges with a stride and reads them through L1/L2), and nothing
// returned to the host until the call is over.
//
// Arithmetic: the plain version's, in float32, in its order wherever one
// thread computes: the same residual, Jacobian (pinhole or KB8), stereo third
// row (optim/ba.py::stereo_row), Huber weight, chi2 gates, damping
// H + lam diag(H) + 1e-9 I, block-Schur inverse (optim/blockinv.py::inv6),
// exponential map, and final re-classification. NaN and inf propagate where
// they do in the plain version (a non-finite row poisons H, and the zeroed
// step leaves the pose where it was). Two things differ: the 27 sums are
// taken in another order (per thread, then a fixed butterfly over each warp,
// then the warps in order: no atomics, so a call repeats to the bit), and the
// projection onto SO(3) is the polar factor by Newton's iteration
// X <- (X + X^-T) / 2, equal to the SVD's U diag(1, 1, det) V^T on a matrix
// of positive determinant, which dR @ R of two rotations always has.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CACHED_PER_THREAD = 2;   // edges a thread keeps in registers
constexpr int NSUM = 32;               // 21 of H, 6 of b, the cost, 4 zero pads
constexpr int PINHOLE = 0;
constexpr float CHI2_STEREO = 7.815f;

struct Cam {
  float fx, fy, cx, cy, k1, k2, k3, k4;
};

struct Edge {
  float x, y, z, u, v, info, invd;
  float valid;   // 0 or 1
  float inl;     // the round's inlier mask, 0 or 1
};

struct Args {
  const float* R0;
  const float* t0;
  const float* Xw;
  const float* uv;
  const uint8_t* valid;
  const float* cam;
  const float* info;    // null: ones
  const float* invd;    // null: mono
  const float* bf;
  float* R_out;
  float* t_out;
  uint8_t* inliers;     // also the strided path's inlier mask between rounds
  long long* n_inliers;
  float* chi2_out;
  int M, rounds, iters, check_cost;
  float chi2_th;
};

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would return lo).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// Camera-frame point, residual e = uv - proj(Xc), G = d e / d Xc and the
// depth; D = 3 rows with the stereo row (zero where invd <= 0).
template <int KIND, bool STEREO, bool JAC>
__device__ __forceinline__ void edge_terms(const Cam& c, const float* P, float bf,
                                           const Edge& E, float e[3], float J[3][6],
                                           float& depth) {
  const float X = P[0] * E.x + P[1] * E.y + P[2] * E.z + P[9];
  const float Y = P[3] * E.x + P[4] * E.y + P[5] * E.z + P[10];
  const float Z = P[6] * E.x + P[7] * E.y + P[8] * E.z + P[11];
  depth = Z;
  float G[3][3];
  if (KIND == PINHOLE) {
    const float zs = fabsf(Z) < 1e-9f ? 1e-9f : Z;
    e[0] = E.u - (c.fx * X / zs + c.cx);
    e[1] = E.v - (c.fy * Y / zs + c.cy);
    if (JAC) {
      const float iz = 1.0f / zs;
      const float iz2 = iz * iz;
      G[0][0] = -(c.fx * iz); G[0][1] = 0.0f; G[0][2] = c.fx * X * iz2;
      G[1][0] = 0.0f; G[1][1] = -(c.fy * iz); G[1][2] = c.fy * Y * iz2;
    }
  } else {
    const float r2 = X * X + Y * Y;
    const float rho = sqrtf(clamp_min(r2, 1e-18f));
    const float th = atan2f(rho, Z);
    const float th2 = th * th;
    const float r_th = th * (1.0f + th2 * (c.k1 + th2 * (c.k2 + th2 * (c.k3 + th2 * c.k4))));
    const bool small = r2 < 1e-18f;
    const float scale = small ? 0.0f : r_th / rho;
    e[0] = E.u - (c.fx * scale * X + c.cx);
    e[1] = E.v - (c.fy * scale * Y + c.cy);
    if (JAC) {
      const float dr_dth = 1.0f + th2 * (3.0f * c.k1 + th2 * (5.0f * c.k2 + th2 *
                           (7.0f * c.k3 + th2 * 9.0f * c.k4)));
      const float n2 = r2 + Z * Z;
      const float dth_dx = Z * X / (rho * n2);
      const float dth_dy = Z * Y / (rho * n2);
      const float dth_dz = -rho / n2;
      float s = r_th / rho;
      float ds_dx = (dr_dth * dth_dx - s * (X / rho)) / rho;
      float ds_dy = (dr_dth * dth_dy - s * (Y / rho)) / rho;
      float ds_dz = dr_dth * dth_dz / rho;
      if (small) s = ds_dx = ds_dy = ds_dz = 0.0f;
      G[0][0] = -(c.fx * (s + X * ds_dx)); G[0][1] = -(c.fx * X * ds_dy);
      G[0][2] = -(c.fx * X * ds_dz);
      G[1][0] = -(c.fy * Y * ds_dx); G[1][1] = -(c.fy * (s + Y * ds_dy));
      G[1][2] = -(c.fy * Y * ds_dz);
    }
  }
  if (STEREO) {
    const float zc = clamp_min(Z, 1e-6f);
    const float has3 = E.invd > 0.0f ? 1.0f : 0.0f;
    const float rect = KIND == PINHOLE ? 1.0f : 0.0f;
    e[2] = has3 * (rect * e[0] - bf * (E.invd - 1.0f / zc));
    if (JAC) {
      G[2][0] = has3 * (rect * G[0][0]);
      G[2][1] = has3 * (rect * G[0][1]);
      G[2][2] = has3 * (rect * G[0][2] - bf / (zc * zc));
    }
  }
  if (JAC) {
    // J = [G, -G hat(Xc)]
#pragma unroll
    for (int k = 0; k < (STEREO ? 3 : 2); ++k) {
      J[k][0] = G[k][0]; J[k][1] = G[k][1]; J[k][2] = G[k][2];
      J[k][3] = -(G[k][1] * Z - G[k][2] * Y);
      J[k][4] = -(G[k][2] * X - G[k][0] * Z);
      J[k][5] = -(G[k][0] * Y - G[k][1] * X);
    }
  }
}

template <bool STEREO>
__device__ __forceinline__ float chi2_of(const float e[3], float info) {
  float s = e[0] * e[0] + e[1] * e[1];
  if (STEREO) s += e[2] * e[2];
  return s * info;
}

__device__ __forceinline__ float huber_weight(float chi2, float d2) {
  return chi2 <= d2 ? 1.0f : sqrtf(d2 / clamp_min(chi2, 1e-12f));
}

__device__ __forceinline__ float huber_cost(float chi2, float d2) {
  return chi2 <= d2 ? chi2 : 2.0f * sqrtf(d2) * sqrtf(clamp_min(chi2, 1e-12f)) - d2;
}

// Sum v[0..31] over the warp: after a reduce-scatter butterfly (31 shuffles
// in all, a fixed order) lane l holds the warp's total of v[l].
__device__ __forceinline__ float warp_sum_scatter(float v[NSUM], int lane) {
#pragma unroll
  for (int half = NSUM / 2; half >= 1; half /= 2) {
    const bool upper = lane & half;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? v[i + half] : v[i];
      const float send = upper ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return v[0];
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// optim/blockinv.py::inv3: adjugate over the guarded determinant.
__device__ void inv3(const float A[3][3], float out[3][3]) {
  const float a = A[0][0], b = A[0][1], c = A[0][2];
  const float d = A[1][0], e = A[1][1], f = A[1][2];
  const float g = A[2][0], h = A[2][1], i = A[2][2];
  const float A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const float A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const float A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  float det = a * A11 + b * A21 + c * A31;
  if (fabsf(det) < 1e-12f) det = 1e-12f;
  out[0][0] = A11 / det; out[0][1] = A12 / det; out[0][2] = A13 / det;
  out[1][0] = A21 / det; out[1][1] = A22 / det; out[1][2] = A23 / det;
  out[2][0] = A31 / det; out[2][1] = A32 / det; out[2][2] = A33 / det;
}

__device__ __forceinline__ void mm3(const float A[3][3], const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) C[r][s] = A[r][0] * B[0][s] + A[r][1] * B[1][s] + A[r][2] * B[2][s];
}

// dx = -inv6(Hd) b, with optim/blockinv.py::inv6's 3x3 block Schur formula.
__device__ void solve6(const float Hd[6][6], const float b[6], float dx[6]) {
  float A[3][3], B[3][3], C[3][3], D[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      A[r][s] = Hd[r][s]; B[r][s] = Hd[r][s + 3];
      C[r][s] = Hd[r + 3][s]; D[r][s] = Hd[r + 3][s + 3];
    }
  float Ai[3][3], AiB[3][3], CAiB[3][3], S[3][3], Si[3][3], CAi[3][3], T[3][3], TL[3][3], BL[3][3];
  inv3(A, Ai);
  mm3(Ai, B, AiB);
  mm3(C, AiB, CAiB);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) S[r][s] = D[r][s] - CAiB[r][s];
  inv3(S, Si);
  mm3(C, Ai, CAi);
  mm3(AiB, Si, T);      // AiB @ Si; the top right block is -T
  mm3(T, CAi, TL);      // (AiB @ Si) @ CAi
  mm3(Si, CAi, BL);     // the bottom left block is -BL
  float Minv[6][6];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      Minv[r][s] = Ai[r][s] + TL[r][s];
      Minv[r][s + 3] = -T[r][s];
      Minv[r + 3][s] = -BL[r][s];
      Minv[r + 3][s + 3] = Si[r][s];
    }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < 6; ++s) acc += Minv[r][s] * b[s];
    dx[r] = -acc;
  }
}

// geometry/lie.py::se3_exp: dx = [rho, phi] -> (dR, dt), dt = Jl(phi) rho.
__device__ void se3_exp(const float dx[6], float dR[3][3], float dt[3]) {
  const float p0 = dx[3], p1 = dx[4], p2 = dx[5];
  const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float theta = sqrtf(clamp_min(theta2, 1e-16f));
  const bool small = theta2 < 1e-8f;
  const float A = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float B = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  const float C = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : (theta - sinf(theta)) / (theta2 * theta);
  const float W[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float WW[3][3];
  mm3(W, W, WW);
  float Jl[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float I = r == s ? 1.0f : 0.0f;
      dR[r][s] = I + A * W[r][s] + B * WW[r][s];
      Jl[r][s] = I + B * W[r][s] + C * WW[r][s];
    }
#pragma unroll
  for (int r = 0; r < 3; ++r) dt[r] = Jl[r][0] * dx[0] + Jl[r][1] * dx[1] + Jl[r][2] * dx[2];
}

// The rotation nearest X (its polar factor) by Newton's iteration
// X <- (X + X^-T) / 2, run until an iteration moves no entry by more than
// two float32 ulps of 1 (quadratic convergence: 2-3 iterations from
// dR @ R); NaN where X is not finite, as lie.normalize_rotation.
__device__ void polar(float X[3][3]) {
  bool finite = true;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) finite = finite && isfinite(X[r][s]);
  if (!finite) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) X[r][s] = nanf("");
    return;
  }
  for (int it = 0; it < 12; ++it) {
    // X^-T = cof(X) / det(X)
    const float c00 = X[1][1] * X[2][2] - X[1][2] * X[2][1];
    const float c01 = X[1][2] * X[2][0] - X[1][0] * X[2][2];
    const float c02 = X[1][0] * X[2][1] - X[1][1] * X[2][0];
    const float c10 = X[0][2] * X[2][1] - X[0][1] * X[2][2];
    const float c11 = X[0][0] * X[2][2] - X[0][2] * X[2][0];
    const float c12 = X[0][1] * X[2][0] - X[0][0] * X[2][1];
    const float c20 = X[0][1] * X[1][2] - X[0][2] * X[1][1];
    const float c21 = X[0][2] * X[1][0] - X[0][0] * X[1][2];
    const float c22 = X[0][0] * X[1][1] - X[0][1] * X[1][0];
    const float inv_det = 1.0f / (X[0][0] * c00 + X[0][1] * c01 + X[0][2] * c02);
    const float cof[3][3] = {{c00, c01, c02}, {c10, c11, c12}, {c20, c21, c22}};
    float moved = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float n = 0.5f * (X[r][s] + cof[r][s] * inv_det);
        moved = fmaxf(moved, fabsf(n - X[r][s]));
        X[r][s] = n;
      }
    if (!(moved > 2.4e-7f)) break;
  }
}

template <int KIND, bool STEREO, bool CACHED>
__global__ void __launch_bounds__(THREADS, 1) pose_opt_kernel(const Args a) {
  __shared__ float red[WARPS][NSUM];   // each warp's sums
  __shared__ float tot[NSUM];
  __shared__ float pose[12];           // R row-major, then t
  __shared__ float pose_new[12];       // the step under the cost test
  __shared__ int counts[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M;
  Cam c;
  c.fx = a.cam[0]; c.fy = a.cam[1]; c.cx = a.cam[2]; c.cy = a.cam[3];
  c.k1 = a.cam[4]; c.k2 = a.cam[5]; c.k3 = a.cam[6]; c.k4 = a.cam[7];
  const float bf = STEREO ? *a.bf : 0.0f;
  if (tid < 12) pose[tid] = tid < 9 ? a.R0[tid] : a.t0[tid - 9];

  auto load = [&](int e) {
    Edge E;
    E.x = a.Xw[3 * e]; E.y = a.Xw[3 * e + 1]; E.z = a.Xw[3 * e + 2];
    E.u = a.uv[2 * e]; E.v = a.uv[2 * e + 1];
    E.info = a.info ? a.info[e] : 1.0f;
    E.invd = STEREO ? a.invd[e] : 0.0f;
    E.valid = a.valid[e] ? 1.0f : 0.0f;
    E.inl = 1.0f;
    return E;
  };
  auto gate = [&](const Edge& E) {
    return STEREO ? (E.invd > 0.0f ? CHI2_STEREO : a.chi2_th) : a.chi2_th;
  };
  Edge cache[CACHED ? CACHED_PER_THREAD : 1];
  if (CACHED) {
#pragma unroll
    for (int k = 0; k < CACHED_PER_THREAD; ++k)
      if (tid + k * THREADS < M) cache[k] = load(tid + k * THREADS);
  } else {
    for (int e = tid; e < M; e += THREADS) a.inliers[e] = 1;
  }
  // Calls f(edge, index) on each of this thread's edges; the edge's inlier
  // mask may be changed by f and is kept.
  auto for_edges = [&](auto&& f) {
    if (CACHED) {
#pragma unroll
      for (int k = 0; k < CACHED_PER_THREAD; ++k)
        if (tid + k * THREADS < M) f(cache[k], tid + k * THREADS);
    } else {
      for (int e = tid; e < M; e += THREADS) {
        Edge E = load(e);
        E.inl = a.inliers[e] ? 1.0f : 0.0f;
        f(E, e);
        a.inliers[e] = E.inl > 0.0f;
      }
    }
  };
  __syncthreads();

  float lam = 0.0f;   // thread 0's
  for (int round = 0; round < a.rounds; ++round) {
    const bool robust = round < a.rounds - 1;
    lam = 1e-3f;
    for (int it = 0; it < a.iters; ++it) {
      float P[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) P[i] = pose[i];
      float v[NSUM];
#pragma unroll
      for (int i = 0; i < NSUM; ++i) v[i] = 0.0f;
      for_edges([&](Edge& E, int) {
        float e[3] = {0.0f, 0.0f, 0.0f}, J[3][6], depth;
        edge_terms<KIND, STEREO, true>(c, P, bf, E, e, J, depth);
        const float chi2 = chi2_of<STEREO>(e, E.info);
        const float d2 = gate(E);
        float w = robust ? huber_weight(chi2, d2) : 1.0f;
        w = w * E.info * E.inl * E.valid * (depth > 0.0f ? 1.0f : 0.0f);
#pragma unroll
        for (int k = 0; k < (STEREO ? 3 : 2); ++k) {
          float wJ[6];
#pragma unroll
          for (int i = 0; i < 6; ++i) wJ[i] = J[k][i] * w;
          int n = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = i; j < 6; ++j) v[n++] += wJ[i] * J[k][j];
          }
#pragma unroll
          for (int i = 0; i < 6; ++i) v[21 + i] += wJ[i] * e[k];
        }
        if (a.check_cost) {
          const float m = E.inl * E.valid;
          v[27] += (robust ? huber_cost(chi2, d2) : chi2) * m;
        }
      });
      const float s = warp_sum_scatter(v, lane);
      red[warp][lane] = s;
      __syncthreads();
      if (warp == 0) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += red[w][lane];
        tot[lane] = acc;
        __syncwarp();
        if (lane == 0) {
          float Hd[6][6], b[6], dx[6];
          int n = 0;
          for (int i = 0; i < 6; ++i)
            for (int j = i; j < 6; ++j) Hd[i][j] = Hd[j][i] = tot[n++];
          for (int i = 0; i < 6; ++i) {
            b[i] = tot[21 + i];
            Hd[i][i] = Hd[i][i] + lam * Hd[i][i] + 1e-9f;
          }
          solve6(Hd, b, dx);
          for (int i = 0; i < 6; ++i) dx[i] = isfinite(dx[i]) ? dx[i] : 0.0f;
          float dR[3][3], dt[3], Rn[3][3];
          se3_exp(dx, dR, dt);
          const float R[3][3] = {{P[0], P[1], P[2]}, {P[3], P[4], P[5]}, {P[6], P[7], P[8]}};
          mm3(dR, R, Rn);
          polar(Rn);
          float* dst = a.check_cost ? pose_new : pose;
          for (int r = 0; r < 3; ++r) {
            for (int s2 = 0; s2 < 3; ++s2) dst[3 * r + s2] = Rn[r][s2];
            dst[9 + r] = dR[r][0] * P[9] + dR[r][1] * P[10] + dR[r][2] * P[11] + dt[r];
          }
        }
      }
      __syncthreads();
      if (a.check_cost) {
        float Pn[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) Pn[i] = pose_new[i];
        float cost = 0.0f;
        for_edges([&](Edge& E, int) {
          float e[3] = {0.0f, 0.0f, 0.0f}, depth;
          edge_terms<KIND, STEREO, false>(c, Pn, bf, E, e, nullptr, depth);
          const float chi2 = chi2_of<STEREO>(e, E.info);
          const float m = E.inl * E.valid;
          cost += (robust ? huber_cost(chi2, gate(E)) : chi2) * m;
        });
        cost = warp_sum(cost);
        if (lane == 0) red[warp][0] = cost;
        __syncthreads();
        if (tid == 0) {
          float cost_new = 0.0f;
          for (int w = 0; w < WARPS; ++w) cost_new += red[w][0];
          const bool better = cost_new < tot[27];
          if (better)
            for (int i = 0; i < 12; ++i) pose[i] = pose_new[i];
          lam = better ? lam * 0.5f : lam * 4.0f;
          lam = fminf(fmaxf(lam, 1e-8f), 1e6f);
        }
        __syncthreads();
      }
    }
    // Re-classify at the round's pose: the next round's inlier mask.
    float P[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) P[i] = pose[i];
    const bool last = round == a.rounds - 1;
    for_edges([&](Edge& E, int idx) {
      float e[3] = {0.0f, 0.0f, 0.0f}, depth;
      edge_terms<KIND, STEREO, false>(c, P, bf, E, e, nullptr, depth);
      const float chi2 = chi2_of<STEREO>(e, E.info);
      E.inl = (chi2 <= gate(E) && depth > 0.0f) ? 1.0f : 0.0f;
      if (last) a.chi2_out[idx] = chi2;
    });
  }
  // inliers = mask & valid, and their count.
  int n = 0;
  for_edges([&](Edge& E, int idx) {
    const bool in = E.inl > 0.0f && E.valid > 0.0f;
    n += in ? 1 : 0;
    if (CACHED) a.inliers[idx] = in;
    else E.inl = in ? 1.0f : 0.0f;
  });
  n = warp_sum(n);
  if (lane == 0) counts[warp] = n;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += counts[w];
    *a.n_inliers = total;
  }
  if (tid < 9) a.R_out[tid] = pose[tid];
  else if (tid < 12) a.t_out[tid - 9] = pose[tid];
}

template <int KIND, bool STEREO>
cudaError_t launch_kind(const Args& a, cudaStream_t stream) {
  if (a.M <= CACHED_PER_THREAD * THREADS)
    pose_opt_kernel<KIND, STEREO, true><<<1, THREADS, 0, stream>>>(a);
  else
    pose_opt_kernel<KIND, STEREO, false><<<1, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One pose_optimization call. Pointers are device pointers; info may be
// null (unit information); invd and bf both null (mono) or both set (stereo
// observations). Returns the launch's cudaError_t.
extern "C" int pose_opt(const float* R0, const float* t0, const float* Xw, const float* uv,
                        const uint8_t* valid, const float* cam, const float* info,
                        const float* invd, const float* bf, float* R_out, float* t_out,
                        uint8_t* inliers, long long* n_inliers, float* chi2_out, int M,
                        int cam_kind, int rounds, int iters, int check_cost, float chi2_th,
                        cudaStream_t stream) {
  const Args a{R0, t0, Xw, uv, valid, cam, info, invd, bf, R_out, t_out, inliers, n_inliers,
               chi2_out, M, rounds, iters, check_cost, chi2_th};
  const bool stereo = invd != nullptr && bf != nullptr;
  if (cam_kind == PINHOLE)
    return stereo ? launch_kind<0, true>(a, stream) : launch_kind<0, false>(a, stream);
  return stereo ? launch_kind<1, true>(a, stream) : launch_kind<1, false>(a, stream);
}
