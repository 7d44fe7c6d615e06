// Robust pose-only Gauss-Newton on SE(3): the whole loop, its early exit
// and its epilogue in one launch of one thread-block cluster.
//
// Replaces the device-side loop of ya_vo_tpu/tracking/pose_solver.py:
// _solve_pose, a jax.lax.while_loop (not a Pallas kernel) that XLA runs
// inside the jitted fused step with no host involvement, leaving it once a
// step's norm is <= 1e-5. Eager PyTorch cannot express that loop: it has to
// read the exit on the host each iteration or issue all iterations blind
// (~140 small launches each). The function is spelled out in
// ya_vo_tpu_torch/tracking/pose_solver.py, whose solve_pose_plain is the
// plain PyTorch version; this kernel computes it formula for formula:
//  * per point under T: r (2), J (2x6, left-multiplicative, v first), the
//    depth Z; valid = mask & Z > 1e-3; w = min(1, delta / sqrt(max(chi2,
//    1e-12))) * (chi2 > chi2_threshold ? 1e-3 : 1) * valid;
//  * H = sum J^T w J + damping I and b = -sum J^T w r, solved by LU with
//    partial pivoting in float32;
//  * dx := 0 unless every component is finite and ||dx|| < 1; T <-
//    se3_exp(dx) T (core/lie.py's formulas, small-angle branch included);
//    exit once ||dx|| <= 1e-5 or after `iters` iterations;
//  * the epilogue: inlier mask (valid & chi2 <= chi2_threshold), its count
//    and the Huber mean cost over valid points at the final T.
//
// What bounds it on an H100: the function reads each point once (21 bytes
// with its mask) and writes one mask byte, about 43 KB for 2048 points
// (~13 ns of HBM), and does ~180 operations a valid point an iteration (a
// masked point adds nothing; ~16 ns of f32 peak for 300 valid points and
// 10 iterations). The kernel is far from both: an iteration is a chain of
// dependent steps (each point's terms, the 27 sums, a 6x6 solve and an
// exponential in one thread, barriers between them), so its time is that
// chain's latency times the iterations the data needs.
//
// The order of the sums, which fixes the bits. Every sum is taken in the
// order of a reference schedule of one block of 256 threads: thread
// t = 32 w + l (warp w, lane l) adds the terms of its points t + 256 k for
// k = 0, 1, ... in k order, starting from 0; a warp folds its 32 sums with
// an xor butterfly (16, 8, 4, 2, 1), which leaves the same bits in every
// lane; the 8 warps' partials are added in warp order, starting from 0.
// There are no atomics. The build's -fmad=false makes every multiply and
// add round on its own, so any schedule that keeps each expression and this
// order gives the same bits (two calls too), whatever runs where.
//
// The design: a cluster of 8 blocks of 256 threads, block c standing in
// for the reference's warp c, so that an iteration costs one point a thread
// where one block took eight.
//  * Thread (s, l) of block c (warp s, lane l) takes the point that the
//    reference thread 32 c + l takes at k = 8 r + s, in round r = 0, 1, ...
//    (a round is 2048 points: round 0's point is loaded once and kept in
//    registers, later rounds' are read from device memory each iteration),
//    and writes its 27 terms to shared memory.
//  * Warp j then adds, for each of its sums q = j, j + 8, ..., lane l's
//    terms over the 8 slices of every round in order: the reference thread
//    32 c + l's sum. The butterfly gives the reference warp c's partial,
//    and lanes 0-7 write it into blocks 0-7's shared memory (distributed
//    shared memory; two buffers, by iteration parity, so a block that runs
//    ahead never overwrites partials another block is still reading).
//  * After cluster.sync() every block adds the 8 partials in warp order,
//    solves, guards and takes the step and reads the exit itself: the same
//    bits in the same code, so every block holds the same T and leaves the
//    loop at the same iteration, with no broadcast to wait for.
//  * The epilogue folds the cost and the counts the same way into block 0,
//    which writes the outputs; each point's inlier flag is written by the
//    thread that owns it.
// Neither the cluster's size nor the shared memory depends on N: any N runs
// in rounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int REF_THREADS = 256;              // the reference block
constexpr int CLUSTER = REF_THREADS / 32;     // one block per reference warp
constexpr int THREADS = 256;
constexpr int SLICES = THREADS / 32;          // k values a round
constexpr int ROUND = SLICES * REF_THREADS;   // points a round
constexpr int NH = 21;          // H's upper triangle, row by row
constexpr int NSUM = NH + 6;    // then b's six entries (before the sign)
// the sums warp s folds: q = s + SLICES j
constexpr int SUMS_PER_WARP = (NSUM + SLICES - 1) / SLICES;

struct Problem {
  const float* T_init; int t_s0, t_s1;
  const float* pts; int p_s0, p_s1;
  const float* uv; int u_s0, u_s1;
  const unsigned char* mask; int m_s0;
  int N, iters;
  float fx, fy, cx, cy, huber_delta, chi2_threshold, damping;
};

// r, J and Z of one point under T (row-major 4x4 in shared memory), as
// _residuals_and_jacobian computes them: J = J_proj @ [I | -hat(pc)] with
// its zero products left out (they change no bits).
__device__ __forceinline__ void residual(const float* T, const Problem& p,
                                         float px, float py, float pz,
                                         float uo, float vo, float& r0,
                                         float& r1, float& Z, float (&J0)[6],
                                         float (&J1)[6]) {
  const float X = T[0] * px + T[1] * py + T[2] * pz + T[3];
  const float Y = T[4] * px + T[5] * py + T[6] * pz + T[7];
  Z = T[8] * px + T[9] * py + T[10] * pz + T[11];
  const float inv_z = 1.0f / (Z < 1e-3f ? 1e-3f : Z);
  const float inv_z2 = inv_z * inv_z;
  r0 = p.fx * X * inv_z + p.cx - uo;
  r1 = p.fy * Y * inv_z + p.cy - vo;
  const float a = p.fx * inv_z, c = -p.fx * X * inv_z2;
  const float b = p.fy * inv_z, d = -p.fy * Y * inv_z2;
  J0[0] = a; J0[1] = 0.0f; J0[2] = c;
  J0[3] = c * Y; J0[4] = a * Z - c * X; J0[5] = -a * Y;
  J1[0] = 0.0f; J1[1] = b; J1[2] = d;
  J1[3] = d * Y - b * Z; J1[4] = -d * X; J1[5] = b * X;
}

// Point i's coordinates, observation and mask (0 and false past N).
__device__ __forceinline__ void load_point(const Problem& p, long long i,
                                           float& px, float& py, float& pz,
                                           float& uo, float& vo, bool& m) {
  const bool in = i < p.N;
  px = in ? p.pts[i * p.p_s0] : 0.0f;
  py = in ? p.pts[i * p.p_s0 + p.p_s1] : 0.0f;
  pz = in ? p.pts[i * p.p_s0 + 2 * p.p_s1] : 0.0f;
  uo = in ? p.uv[i * p.u_s0] : 0.0f;
  vo = in ? p.uv[i * p.u_s0 + p.u_s1] : 0.0f;
  m = in && p.mask[i * p.m_s0] != 0;
}

// One point's 27 terms under T: H's upper triangle, row by row, then b
// (before the sign), each term = J0[a] jw0[l] + J1[a] jw1[l], the
// expression whose sum over points is the normal equations. Every point
// takes part, a masked one with weight 0 (as in the plain version, where
// 0 * J adds nothing unless J is not finite).
__device__ __forceinline__ void point_terms(const float* T, const Problem& p,
                                            float px, float py, float pz,
                                            float uo, float vo, bool m,
                                            float (&t)[NSUM]) {
  float r0, r1, Z, J0[6], J1[6];
  residual(T, p, px, py, pz, uo, vo, r0, r1, Z, J0, J1);
  const float chi2 = r0 * r0 + r1 * r1;
  const bool valid = m && Z > 1e-3f;
  // the ternaries keep torch.clamp's NaN (fmaxf/fminf would drop it)
  const float nrm = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
  const float wh = p.huber_delta / nrm;
  const float w_huber = wh > 1.0f ? 1.0f : wh;
  const float w_gate = chi2 > p.chi2_threshold ? 1e-3f : 1.0f;
  const float w = w_huber * w_gate * (valid ? 1.0f : 0.0f);
  float jw0[6], jw1[6];
#pragma unroll
  for (int l = 0; l < 6; ++l) { jw0[l] = J0[l] * w; jw1[l] = J1[l] * w; }
  int q = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int l = a; l < 6; ++l) t[q++] = J0[a] * jw0[l] + J1[a] * jw1[l];
#pragma unroll
  for (int a = 0; a < 6; ++a) t[NH + a] = jw0[a] * r0 + jw1[a] * r1;
}

// The epilogue's terms of point i at the final T: its inlier flag (written
// out), its Huber cost, and whether it is valid and an inlier.
__device__ __forceinline__ float finish_point(const float* T, const Problem& p,
                                              long long i, float px, float py,
                                              float pz, float uo, float vo,
                                              bool m,
                                              unsigned char* out_inliers,
                                              bool& valid, bool& inl) {
  float r0, r1, Z, J0[6], J1[6];
  residual(T, p, px, py, pz, uo, vo, r0, r1, Z, J0, J1);
  const float chi2 = r0 * r0 + r1 * r1;
  valid = m && Z > 1e-3f;
  inl = valid && chi2 <= p.chi2_threshold;
  out_inliers[i] = inl;
  const float nrm = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
  return nrm <= p.huber_delta
      ? 0.5f * chi2 : p.huber_delta * (nrm - 0.5f * p.huber_delta);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x := A^-1 x by LU with partial pivoting (the first largest pivot, as
// LAPACK's getrf picks it); A is overwritten.
__device__ void lu_solve6(float (&A)[6][6], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > best) { best = fabsf(A[i][k]); piv = i; }
    // the row swap over constant indices keeps A in registers
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (i == piv) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j]; A[k][j] = A[i][j]; A[i][j] = t;
        }
        const float t = x[k]; x[k] = x[i]; x[i] = t;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      x[i] -= l * x[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

// T := se3_exp(xi) @ T, with core/lie.py's _sinc_coeffs and se3_exp.
__device__ void se3_update(const float (&xi)[6], float* T) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-8f;
  const float safe = small ? 1.0f : th2;
  const float th = sqrtf(safe);
  const float s = sinf(th), co = cosf(th);
  const float A = small ? 1.0f - th2 / 6.0f : s / th;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - co) / safe;
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f : (th - s) / (safe * th);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j]
                       + W[i][2] * W[2][j];
      const float I = i == j ? 1.0f : 0.0f;
      E[i][j] = I + A * W[i][j] + B * W2;
      t += (I + B * W[i][j] + C * W2) * xi[j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  float out[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = E[i][0] * T[j] + E[i][1] * T[4 + j]
                       + E[i][2] * T[8 + j] + E[i][3] * T[12 + j];
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = out[k];
}

// The GN step at the summed normal equations hb (block-shared), taken by
// one thread: the 6x6 solve, the guard and T := se3_exp(dx) T. Returns
// whether the loop ends (||dx|| <= 1e-5, a zeroed step included).
__device__ bool gn_update(const float* hb, float damping, float* T) {
  float A[6][6], dx[6];
  int q = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int l = a; l < 6; ++l) A[a][l] = A[l][a] = hb[q++];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    A[a][a] += damping;
    dx[a] = -hb[NH + a];
  }
  lu_solve6(A, dx);
  bool finite = true;
  float ss = 0.0f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    finite = finite && isfinite(dx[a]);
    ss += dx[a] * dx[a];
  }
  float step = sqrtf(ss);
  if (!(finite && step < 1.0f)) {
#pragma unroll
    for (int a = 0; a < 6; ++a) dx[a] = 0.0f;
    step = 0.0f;
  }
  se3_update(dx, T);
  return !(step > 1e-5f);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
pose_gn_kernel(Problem p, float* __restrict__ out_pose,
               unsigned char* __restrict__ out_inliers,
               long long* __restrict__ out_n_inliers,
               float* __restrict__ out_cost, int* __restrict__ out_iters) {
  __shared__ float sT[16];
  __shared__ float terms[NSUM][SLICES][32];   // a round's terms
  __shared__ float red[2][CLUSTER][NSUM];     // the reference warps' partials
  __shared__ float hb[NSUM];
  __shared__ int s_done;
  __shared__ float e_cost[SLICES][32];        // the epilogue's terms
  __shared__ unsigned char e_flags[SLICES][32];
  __shared__ float e_red[CLUSTER];            // its partials, in block 0
  __shared__ int e_ired[CLUSTER][2];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, s = tid >> 5;
  const int rounds = (int)((p.N + (long long)ROUND - 1) / ROUND);
  // the reference thread 32 c + lane's point at k = SLICES * r + slice
  const auto point = [&](int r, int slice) {
    return (long long)REF_THREADS * (SLICES * r + slice) + 32 * c + lane;
  };

  if (tid < 16) sT[tid] = p.T_init[(tid >> 2) * p.t_s0 + (tid & 3) * p.t_s1];
  float px, py, pz, uo, vo;
  bool m;
  load_point(p, point(0, s), px, py, pz, uo, vo, m);
  cluster.sync();  // every block has started before any writes into it

  int it = 0;
  while (it < p.iters) {
    float acc[SUMS_PER_WARP];
#pragma unroll
    for (int j = 0; j < SUMS_PER_WARP; ++j) acc[j] = 0.0f;
    for (int r = 0; r < rounds; ++r) {
      const long long i = point(r, s);
      if (i < p.N) {
        float t[NSUM];
        if (r == 0) {
          point_terms(sT, p, px, py, pz, uo, vo, m, t);
        } else {
          float qx, qy, qz, qu, qv;
          bool qm;
          load_point(p, i, qx, qy, qz, qu, qv, qm);
          point_terms(sT, p, qx, qy, qz, qu, qv, qm, t);
        }
#pragma unroll
        for (int q = 0; q < NSUM; ++q) terms[q][s][lane] = t[q];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SUMS_PER_WARP; ++j) {
        const int q = s + SLICES * j;
        if (q < NSUM) {
#pragma unroll
          for (int sl = 0; sl < SLICES; ++sl)
            if (point(r, sl) < p.N) acc[j] += terms[q][sl][lane];
        }
      }
      if (r + 1 < rounds) __syncthreads();
    }
    // the reference warp c's partials, into every block's red[it & 1][c]
#pragma unroll
    for (int j = 0; j < SUMS_PER_WARP; ++j) {
      const int q = s + SLICES * j;
      if (q < NSUM) {
        const float v = warp_sum(acc[j]);
        if (lane < CLUSTER)
          *cluster.map_shared_rank(&red[it & 1][c][q], lane) = v;
      }
    }
    cluster.sync();
    if (tid < NSUM) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < CLUSTER; ++w) sum += red[it & 1][w][tid];
      hb[tid] = sum;
    }
    __syncthreads();
    if (tid == 0) s_done = gn_update(hb, p.damping, sT);
    __syncthreads();
    ++it;
    if (s_done) break;
  }

  // the epilogue at the final T: inliers, their count, the Huber mean cost
  float csum = 0.0f;
  int n_valid = 0, n_inl = 0;
  for (int r = 0; r < rounds; ++r) {
    const long long i = point(r, s);
    if (i < p.N) {
      bool valid, inl;
      float cost;
      if (r == 0) {
        cost = finish_point(sT, p, i, px, py, pz, uo, vo, m, out_inliers,
                            valid, inl);
      } else {
        float qx, qy, qz, qu, qv;
        bool qm;
        load_point(p, i, qx, qy, qz, qu, qv, qm);
        cost = finish_point(sT, p, i, qx, qy, qz, qu, qv, qm, out_inliers,
                            valid, inl);
      }
      e_cost[s][lane] = cost;
      e_flags[s][lane] = (unsigned char)(valid | (inl << 1));
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl)
        if (point(r, sl) < p.N) {
          const int f = e_flags[sl][lane];
          if (f & 1) csum += e_cost[sl][lane];
          n_valid += f & 1;
          n_inl += f >> 1;
        }
    }
    if (r + 1 < rounds) __syncthreads();
  }
  if (s == 0) {
    csum = warp_sum(csum);
    n_valid = warp_sum(n_valid);
    n_inl = warp_sum(n_inl);
    if (lane == 0) {
      *cluster.map_shared_rank(&e_red[c], 0) = csum;
      *cluster.map_shared_rank(&e_ired[c][0], 0) = n_valid;
      *cluster.map_shared_rank(&e_ired[c][1], 0) = n_inl;
    }
  }
  cluster.sync();
  if (c != 0) return;
  if (tid == 0) {
    float sum = 0.0f;
    int nv = 0, ni = 0;
#pragma unroll
    for (int w = 0; w < CLUSTER; ++w) {
      sum += e_red[w];
      nv += e_ired[w][0];
      ni += e_ired[w][1];
    }
    *out_cost = sum / (float)(nv > 1 ? nv : 1);
    *out_n_inliers = ni;
    *out_iters = it;
  }
  if (tid < 16) out_pose[tid] = sT[tid];
}

}  // namespace

extern "C" int yavo_pose_gn(const float* T_init, int t_s0, int t_s1,
                            const float* pts, int p_s0, int p_s1,
                            const float* uv, int u_s0, int u_s1,
                            const unsigned char* mask, int m_s0, int N,
                            int iters, float fx, float fy, float cx, float cy,
                            float huber_delta, float chi2_threshold,
                            float damping, float* out_pose,
                            unsigned char* out_inliers,
                            long long* out_n_inliers, float* out_cost,
                            int* out_iters, void* stream) {
  if (N < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  Problem p{T_init, t_s0, t_s1, pts, p_s0, p_s1, uv, u_s0, u_s1, mask, m_s0,
            N, iters, fx, fy, cx, cy, huber_delta, chi2_threshold, damping};
  // one cluster (its size is the kernel's __cluster_dims__); a launch the
  // card refuses returns its error here
  pose_gn_kernel<<<CLUSTER, THREADS, 0, (cudaStream_t)stream>>>(
      p, out_pose, out_inliers, out_n_inliers, out_cost, out_iters);
  return (int)cudaGetLastError();
}

extern "C" int yavo_pose_gn_cluster_size() { return CLUSTER; }
