// Robust pose-only Gauss-Newton on SE(3): the whole loop, its early exit
// and its epilogue in one launch, one thread block a solve.
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
// 10 iterations). The kernel is far from both: each
// iteration is a serial chain (a block reduction of 27 sums, a 6x6 solve
// and an exponential in one thread, two barriers), so its time is that
// chain's latency times the iterations the data needs.
//
// What the design does about it: one block of 256 threads holds the first
// 2048 points in registers (8 a thread, loaded once; only T changes between
// iterations, kept in shared memory), so at the main path's sizes an
// iteration touches no device memory; points past 2048 (a track table
// larger than VOConfig()'s) are read again from device memory each
// iteration. The loop ends on the device as soon as the step is small, so a
// well-seeded frame pays for the few iterations it needs and not 40; the
// host sees one launch and never reads the exit.
//
// Determinism: every sum is taken in a fixed order (each thread over its
// register points in order, then over its points past 2048 in order, xor
// butterflies within a warp, which leave the same bits in every lane, then
// the warps' partials in warp order) with no atomics, so two calls on the
// same inputs are bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;
constexpr int MAX_N = THREADS * PER_THREAD;
constexpr int NH = 21;          // H's upper triangle, row by row
constexpr int NSUM = NH + 6;    // then b's six entries (before the sign)

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

// One point's terms of H's upper triangle and of b (before the sign) under
// T, added to acc. Every point takes part, a masked one with weight 0 (as
// in the plain version, where 0 * J adds nothing unless J is not finite).
__device__ __forceinline__ void accumulate(const float* T, const Problem& p,
                                           float px, float py, float pz,
                                           float uo, float vo, bool m,
                                           float (&acc)[NSUM]) {
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
    for (int l = a; l < 6; ++l)
      acc[q++] += J0[a] * jw0[l] + J1[a] * jw1[l];
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[NH + a] += jw0[a] * r0 + jw1[a] * r1;
}

// The epilogue's terms of point i at the final T: its inlier flag (written
// out), and its Huber cost, validity and inlier count added to the sums.
__device__ __forceinline__ void finish_point(const float* T, const Problem& p,
                                             long long i, float px, float py,
                                             float pz, float uo, float vo,
                                             bool m,
                                             unsigned char* out_inliers,
                                             float& csum, int& n_valid,
                                             int& n_inl) {
  float r0, r1, Z, J0[6], J1[6];
  residual(T, p, px, py, pz, uo, vo, r0, r1, Z, J0, J1);
  const float chi2 = r0 * r0 + r1 * r1;
  const bool valid = m && Z > 1e-3f;
  const bool inl = valid && chi2 <= p.chi2_threshold;
  out_inliers[i] = inl;
  const float nrm = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
  const float cost = nrm <= p.huber_delta
      ? 0.5f * chi2 : p.huber_delta * (nrm - 0.5f * p.huber_delta);
  if (valid) csum += cost;
  n_valid += valid;
  n_inl += inl;
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
    if (piv != k) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float t = A[k][j]; A[k][j] = A[piv][j]; A[piv][j] = t;
      }
      const float t = x[k]; x[k] = x[piv]; x[piv] = t;
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

__global__ void __launch_bounds__(THREADS)
pose_gn_kernel(Problem p, float* __restrict__ out_pose,
               unsigned char* __restrict__ out_inliers,
               long long* __restrict__ out_n_inliers,
               float* __restrict__ out_cost, int* __restrict__ out_iters) {
  __shared__ float sT[16];
  __shared__ float red[WARPS][NSUM];
  __shared__ float hb[NSUM];
  __shared__ int s_done;
  __shared__ int ired[WARPS][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < 16) sT[tid] = p.T_init[(tid >> 2) * p.t_s0 + (tid & 3) * p.t_s1];
  // this thread's first points: i = k * THREADS + tid, loaded once; its
  // points past MAX_N (i = MAX_N + tid + j * THREADS) are read when used
  float px[PER_THREAD], py[PER_THREAD], pz[PER_THREAD];
  float uo[PER_THREAD], vo[PER_THREAD];
  bool m[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k)
    load_point(p, k * THREADS + tid, px[k], py[k], pz[k], uo[k], vo[k], m[k]);
  __syncthreads();

  int it = 0;
  while (it < p.iters) {
    float acc[NSUM];
#pragma unroll
    for (int q = 0; q < NSUM; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      if (k * THREADS + tid < p.N)
        accumulate(sT, p, px[k], py[k], pz[k], uo[k], vo[k], m[k], acc);
    for (long long i = MAX_N + tid; i < p.N; i += THREADS) {
      float qx, qy, qz, qu, qv;
      bool qm;
      load_point(p, i, qx, qy, qz, qu, qv, qm);
      accumulate(sT, p, qx, qy, qz, qu, qv, qm, acc);
    }
#pragma unroll
    for (int q = 0; q < NSUM; ++q) {
      const float v = warp_sum(acc[q]);
      if (lane == 0) red[warp][q] = v;
    }
    __syncthreads();
    if (tid < NSUM) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][tid];
      hb[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float A[6][6], dx[6];
      int q = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int l = a; l < 6; ++l) A[a][l] = A[l][a] = hb[q++];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        A[a][a] += p.damping;
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
      se3_update(dx, sT);
      s_done = !(step > 1e-5f);
    }
    __syncthreads();
    ++it;
    if (s_done) break;
  }

  // the epilogue at the final T: inliers, their count, the Huber mean cost
  float csum = 0.0f;
  int n_valid = 0, n_inl = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = k * THREADS + tid;
    if (i < p.N)
      finish_point(sT, p, i, px[k], py[k], pz[k], uo[k], vo[k], m[k],
                   out_inliers, csum, n_valid, n_inl);
  }
  for (long long i = MAX_N + tid; i < p.N; i += THREADS) {
    float qx, qy, qz, qu, qv;
    bool qm;
    load_point(p, i, qx, qy, qz, qu, qv, qm);
    finish_point(sT, p, i, qx, qy, qz, qu, qv, qm, out_inliers, csum,
                 n_valid, n_inl);
  }
  csum = warp_sum(csum);
  n_valid = warp_sum(n_valid);
  n_inl = warp_sum(n_inl);
  if (lane == 0) {
    red[warp][0] = csum;
    ired[warp][0] = n_valid;
    ired[warp][1] = n_inl;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    int nv = 0, ni = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s += red[w][0];
      nv += ired[w][0];
      ni += ired[w][1];
    }
    *out_cost = s / (float)(nv > 1 ? nv : 1);
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
  pose_gn_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      p, out_pose, out_inliers, out_n_inliers, out_cost, out_iters);
  return (int)cudaGetLastError();
}
