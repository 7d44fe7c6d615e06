// The window bundle adjustment's Gauss-Newton loop (K5): every iteration,
// its early exit, and the start's and the end's costs, in one cooperative
// launch that ends on the device.
//
// Replaces the device-side loop of ya_vo_tpu/ba/window.py: _solve_window, a
// jax.lax.while_loop (not a Pallas kernel) that XLA runs inside one jitted
// program, leaving it once an iteration's relative cost decrease is at or
// below rel_tol. Eager PyTorch cannot express that loop: it reads the exit
// on the host after every iteration, and an iteration is several hundred
// small kernels. The function is spelled out in
// ya_vo_tpu_torch/ba/window.py, whose solve_window_plain is the plain
// PyTorch version; this kernel computes it formula for formula:
//  * start: cost0 and the valid observations at the input; init_inv, the
//    inverse of each input pose (LU with partial pivoting), for the prior;
//  * per observation of landmark l in keyframe k at (T, X): r (2), the 2x6
//    pose Jacobian (left-multiplicative, v first) and the 2x3 landmark
//    Jacobian; valid = obs_valid & pose_valid & lm_valid & z > 1e-2 and at
//    least 2 such observations of l; the Huber weight and cost;
//  * per keyframe Hpp and bp; per landmark Hll, bl and Wpl (one 6x3 block a
//    keyframe), then Hll^-1 = inv(Hll + damping I);
//  * S = blockdiag(Hpp) - sum_l Wpl Hll^-1 Wpl^T, b_red = bp - sum_l Wpl
//    Hll^-1 bl; the gauge pin of 1e8 on the first n_fixed blocks, damping I,
//    and with a prior w: + w I, b_red -= w se3_log(T T_init^-1), and the
//    prior's cost added to cost_prev;
//  * the 6W x 6W solve by LU with partial pivoting (the first largest
//    pivot, as LAPACK's getrf picks it) in float32; the step is 0 unless
//    every entry is finite; the pinned poses' steps are 0;
//  * dxl = Hll^-1 (bl - Wpl^T dxp), zeroed unless the solve was finite and
//    the landmark valid, clamped to +-5; T' = se3_exp(dxp) T (core/lie.py's
//    formulas, small-angle branch included);
//  * per landmark the costs lmA at (T', X + dxl) and lmB at (T', X) (each
//    with its own validity), the landmark takes its candidate where lmA <=
//    lmB; mixed = sum min(lmA, lmB) + prior_cost(T'); the step is taken
//    where mixed < cost_prev, improvement = (cost_prev - mixed) /
//    max(cost_prev, 1e-12), else 0; the loop goes on while it < iters and
//    improvement > rel_tol;
//  * end: cost1 at the final state.
//
// What bounds it on an H100: the function reads the problem once (about
// 0.38 MB at the main path's W 8, O 2048, L 4096: 0.11 us of HBM) and does
// some 10-30 MFLOP an iteration (each valid observation's terms and three
// cost evaluations, each landmark's m^2 6x6 blocks of S for the m keyframes
// that see it, the 48x48 LU): well under a microsecond an iteration at the
// float32 peak, so the bound is set by operations. The kernel is far from
// it: an iteration is a chain of dependent phases (the landmarks' terms,
// the system's sums across blocks, a 48-step LU, back-substitution and the
// costs, the exit) joined by three grid-wide barriers, so its time is that
// chain's latency times the iterations the data needs.
//
// The design: one cooperative launch of as many co-resident blocks of 256
// threads as the landmarks need (at most what the card holds at once),
// landmark-major. The landmarks are cut into chunks of 32 (4 batches of 8,
// one landmark a warp), chunk c taken by block c mod gridDim.x; a landmark
// stays with its warp through every phase, so only that warp ever reads or
// writes its position.
//  A. Each warp takes one landmark a batch: its observations (a CSR run,
//     ascending flat order) in rounds of 32 lanes, their count of valid
//     ones, their terms, and the landmark's sums: Hll, bl and its cost by
//     a butterfly over lanes, and per keyframe Wpl, Hpp's and bp's shares
//     by a segmented scan over a keyframe's run (a landmark seen twice in
//     one keyframe) into shared memory; then Hll^-1 and A = Wpl Hll^-1.
//     After each batch, each thread adds the batch's 8 landmarks, in
//     order, into the block's partial sums of the entries it owns (Hpp,
//     bp, the S blocks Wpl Hll^-1 Wpl^T, the b_red terms, the cost); after
//     a chunk the partials go to global memory, one column a chunk.
//  Grid barrier. Each warp of the grid adds an entry's chunk partials in a
//     fixed order (lane j takes chunks j, j + 32, ..., then a butterfly).
//  Grid barrier.
//  B. Every block assembles the 6W x 6W system from the totals in its
//     shared memory and solves it itself, with the same bits in every block
//     (the same code on the same data), so no broadcast is needed; then the
//     step's poses.
//  C. Each warp back-substitutes its landmarks and evaluates lmA and lmB;
//     the chunk's sum of min(lmA, lmB) goes to global memory.
//  Grid barrier.
//  D. Every block adds the chunks' sums, decides the step and the exit,
//     and applies the step (the poses in its shared memory; each warp its
//     landmarks).
// No float atomics: every sum is taken in a fixed order (a lane's terms in
// round order, then a butterfly; a chunk's landmarks in order; the chunks
// as above), and the chunk partition depends on L alone, so two calls give
// the same bits on any card. The build's -fmad=false makes every multiply
// and add round on its own, as in the plain version's elementwise terms;
// the 6W x 6W LU's updates and back-substitution and the products summed
// into S and b_red are explicit fused multiply-adds (fmaf), as LAPACK's
// getrf and a GEMM compute them for the plain version and JAX. Where a
// window's last improvement sits near rel_tol, its iteration count follows
// such rounding in every float32 version (PERF.md). The landmark cost that
// enters cost_prev and the one that enters mixed are summed by the same
// code in the same order, so a step that changes nothing is not taken.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;                   // landmarks a partial sum
constexpr int BATCHES = CHUNK / WARPS;      // one landmark a warp a batch
constexpr int WMAX = 16;                    // 16 W pose entries <= THREADS
constexpr unsigned FULL = 0xffffffffu;
constexpr float PIN = 1e8f;                 // _gauge_fix's pose_weight

struct Problem {
  const float* poses;               // [W, 4, 4]
  const unsigned char* pose_valid;  // [W]
  const float* landmarks;           // [L, 3]
  const unsigned char* lm_valid;    // [L]
  const float* obs_uv;              // [W * O, 2]
  const unsigned char* obs_valid;   // [W * O]
  const long long* order;           // [W * O] the CSR's flat indices
  const long long* offsets;         // [L + 1] each landmark's run
  int W, O, L, iters, n_fixed;
  float fx, fy, cx, cy, huber_delta, damping, rel_tol, prior_w;
};

struct Outputs {
  float* poses;
  float* landmarks;
  float* cost_initial;
  float* cost_final;
  long long* n_obs;
  int* n_iters;
};

// Where each sum lives: the entries of the reduced system's sums (Hpp
// [W][6][6], bp [W][6], S_off [6W][6W], b_off [6W], the cost), a warp's
// landmark buffer in shared memory (bl, cost, then Wpl, A = Wpl Hll^-1,
// Hpp's and bp's shares, each [W][...]) and a landmark's record in global
// memory (Hll^-1, bl, Wpl).
struct Layout {
  int W, n, nchunks;
  int hpp, bp, soff, boff, cost, E;
  int wpl, a, lhpp, lbp, lmb;
  int lms;
  int pose_floats, unions;
};

__host__ __device__ inline Layout layout(int W, int L) {
  Layout g;
  g.W = W;
  g.n = 6 * W;
  g.nchunks = L > 0 ? (L + CHUNK - 1) / CHUNK : 1;
  g.hpp = 0;
  g.bp = 36 * W;
  g.soff = 42 * W;
  g.boff = g.soff + g.n * g.n;
  g.cost = g.boff + g.n;
  g.E = g.cost + 1;
  g.wpl = 4;
  g.a = g.wpl + 18 * W;
  g.lhpp = g.a + 18 * W;
  g.lbp = g.lhpp + 36 * W;
  g.lmb = g.lbp + 6 * W;
  g.lms = 12 + 18 * W;
  // sT, sNew, sInv [W][16], sDev, sX [6W], rounded to 16 bytes
  g.pose_floats = (3 * 16 * W + 2 * 6 * W + 3) / 4 * 4;
  const int a_phase = g.E + WARPS * g.lmb;
  const int b_phase = g.n * (g.n + 1);
  g.unions = a_phase > b_phase ? a_phase : b_phase;
  return g;
}

// The global scratch, carved from one workspace.
struct Work {
  float* part;        // [E][nchunks] the chunks' partial sums
  float* total;       // [E]
  float* lmstore;     // [L][lms]
  unsigned* lmmask;   // [L] keyframes with a share in the landmark's blocks
  float* cand;        // [L][3] the candidate positions
  int* better;        // [L] lmA <= lmB
  float* cpart;       // [nchunks] a chunk's sum of min(lmA, lmB) (start:
  int* npart;         //   its cost) and its valid observations
  float* epart;       // [nchunks] a chunk's cost at the end
};

inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

size_t carve(const Layout& g, int L, char* base, Work* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align16(bytes);
    return p;
  };
  const size_t Lc = L > 0 ? (size_t)L : 1;
  Work k;
  k.part = (float*)take(sizeof(float) * g.E * (size_t)g.nchunks);
  k.total = (float*)take(sizeof(float) * g.E);
  k.lmstore = (float*)take(sizeof(float) * g.lms * Lc);
  k.lmmask = (unsigned*)take(sizeof(unsigned) * Lc);
  k.cand = (float*)take(sizeof(float) * 3 * Lc);
  k.better = (int*)take(sizeof(int) * Lc);
  k.cpart = (float*)take(sizeof(float) * g.nchunks);
  k.npart = (int*)take(sizeof(int) * g.nchunks);
  k.epart = (float*)take(sizeof(float) * g.nchunks);
  if (w) *w = k;
  return off;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// A warp's sum of v[0..n) in the fixed order of every chunk reduction:
// lane j adds v[j], v[j + 32], ... in order, then a butterfly.
__device__ __forceinline__ float chunk_sum(const float* v, int n, int lane) {
  float s = 0.0f;
  for (int c = lane; c < n; c += 32) s += v[c];
  return warp_sum(s);
}

// B := A^-1 B by LU with partial pivoting (the first largest pivot); A is
// overwritten. One thread, in registers.
template <int N, int M>
__device__ __forceinline__ void lu_small(float (&A)[N][N], float (&B)[N][M]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i)
      if (fabsf(A[i][k]) > best) { best = fabsf(A[i][k]); piv = i; }
#pragma unroll
    for (int i = k + 1; i < N; ++i)
      if (i == piv) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float t = A[k][j]; A[k][j] = A[i][j]; A[i][j] = t;
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const float t = B[k][j]; B[k][j] = B[i][j]; B[i][j] = t;
        }
      }
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < N; ++j) A[i][j] -= l * A[k][j];
#pragma unroll
      for (int j = 0; j < M; ++j) B[i][j] -= l * B[k][j];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = B[i][j];
#pragma unroll
      for (int m = i + 1; m < N; ++m) s -= A[i][m] * B[m][j];
      B[i][j] = s / A[i][i];
    }
}

// core/lie.py's _sinc_coeffs.
__device__ __forceinline__ void sinc_coeffs(float th2, float& A, float& B,
                                            float& C) {
  const bool small = th2 < 1e-8f;
  const float safe = small ? 1.0f : th2;
  const float th = sqrtf(safe);
  const float s = sinf(th), co = cosf(th);
  A = small ? 1.0f - th2 / 6.0f : s / th;
  B = small ? 0.5f - th2 / 24.0f : (1.0f - co) / safe;
  C = small ? 1.0f / 6.0f - th2 / 120.0f : (th - s) / (safe * th);
}

// T := se3_exp(xi) @ T (row-major 4x4).
__device__ void se3_update(const float* xi, float* T) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  float A, B, C;
  sinc_coeffs(w0 * w0 + w1 * w1 + w2 * w2, A, B, C);
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

// out := se3_log(P @ Q) (core/lie.py's so3_log and se3_log).
__device__ void se3_log_of_product(const float* P, const float* Q,
                                   float* out) {
  float M[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      M[i][j] = P[i * 4] * Q[j] + P[i * 4 + 1] * Q[4 + j]
                + P[i * 4 + 2] * Q[8 + j] + P[i * 4 + 3] * Q[12 + j];
  const float tr = M[0][0] + M[1][1] + M[2][2];
  const float lo = (float)(-1.0 + 1e-7);
  float ct = (tr - 1.0f) * 0.5f;
  ct = ct < lo ? lo : (ct > 1.0f ? 1.0f : ct);
  const float theta = acosf(ct);
  float A, B, C;
  sinc_coeffs(theta * theta, A, B, C);
  const float f = 0.5f / (A < 1e-6f ? 1e-6f : A);
  const float w0 = f * (M[2][1] - M[1][2]);
  const float w1 = f * (M[0][2] - M[2][0]);
  const float w2 = f * (M[1][0] - M[0][1]);
  sinc_coeffs(w0 * w0 + w1 * w1 + w2 * w2, A, B, C);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float V[3][3], v[3][1];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j]
                       + W[i][2] * W[2][j];
      V[i][j] = (i == j ? 1.0f : 0.0f) + B * W[i][j] + C * W2;
    }
    v[i][0] = M[i][3];
  }
  lu_small<3, 1>(V, v);
  out[0] = v[0][0]; out[1] = v[1][0]; out[2] = v[2][0];
  out[3] = w0; out[4] = w1; out[5] = w2;
}

// out := T^-1 (4x4, LU with partial pivoting, as torch.linalg.inv).
__device__ void inverse4(const float* T, float* out) {
  float A[4][4], B[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      A[i][j] = T[i * 4 + j];
      B[i][j] = i == j ? 1.0f : 0.0f;
    }
  lu_small<4, 4>(A, B);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i * 4 + j] = B[i][j];
}

// 0.5 w sum(d * d) over the [W][6] deviations, in order.
__device__ float prior_cost(const float* dev, int n, float w) {
  float s = 0.0f;
  for (int r = 0; r < n; ++r) s += dev[r] * dev[r];
  return (0.5f * w) * s;
}

__device__ __forceinline__ float depth(const float* T, float X0, float X1,
                                       float X2) {
  return T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
}

__device__ __forceinline__ float huber(float chi2, float nrm, float hd) {
  return nrm <= hd ? 0.5f * chi2 : hd * (nrm - 0.5f * hd);
}

// A landmark's run of observations and its validity in the first pass.
struct Run {
  long long beg, end;
  bool lmv;
};

__device__ __forceinline__ Run landmark_run(const Problem& p, int l) {
  return Run{p.offsets[l], p.offsets[l + 1], p.lm_valid[l] != 0};
}

// Observation o's keyframe and whether it passes every test but the count
// at (T, X).
__device__ __forceinline__ bool pretest(const Problem& p, const float* T,
                                        long long f, int k, float X0,
                                        float X1, float X2, bool lmv) {
  return p.obs_valid[f] && p.pose_valid[k] && lmv
         && depth(T + 16 * k, X0, X1, X2) > 1e-2f;
}

// The number of observations of the run that pass `pretest` (a warp).
__device__ int count_valid(const Problem& p, const float* T, const Run& run,
                           float X0, float X1, float X2, int lane) {
  int cnt = 0;
  for (long long base = run.beg; base < run.end; base += 32) {
    const long long o = base + lane;
    bool pre = false;
    if (o < run.end) {
      const long long f = p.order[o];
      pre = pretest(p, T, f, (int)(f / p.O), X0, X1, X2, run.lmv);
    }
    cnt += __popc(__ballot_sync(FULL, pre));
  }
  return cnt;
}

// The projection of X into keyframe T: residual, camera-frame point and
// the projection's Jacobian entries (a, c / b, d of J_proj's two rows).
struct Proj {
  float x, y, z, r0, r1, a, b, c, d;
};

__device__ __forceinline__ Proj project(const Problem& p, const float* T,
                                        float X0, float X1, float X2,
                                        float uo, float vo) {
  Proj q;
  q.x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  q.y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  q.z = depth(T, X0, X1, X2);
  const float zs = q.z < 1e-2f ? 1e-2f : q.z;
  const float iz = 1.0f / zs;
  const float iz2 = iz * iz;
  q.r0 = p.fx * q.x * iz + p.cx - uo;
  q.r1 = p.fy * q.y * iz + p.cy - vo;
  q.a = p.fx * iz;
  q.c = -p.fx * q.x * iz2;
  q.b = p.fy * iz;
  q.d = -p.fy * q.y * iz2;
  return q;
}

// A landmark's robust cost at (T, X) and its valid observations (a warp;
// every lane gets the same sum): the lanes' terms in round order, then a
// butterfly.
__device__ float landmark_cost(const Problem& p, const float* T,
                               const Run& run, float X0, float X1, float X2,
                               int lane, int* n_valid) {
  const int cnt = count_valid(p, T, run, X0, X1, X2, lane);
  const bool enough = cnt >= 2;
  float c = 0.0f;
  if (enough) {
    for (long long base = run.beg; base < run.end; base += 32) {
      const long long o = base + lane;
      if (o < run.end) {
        const long long f = p.order[o];
        const int k = (int)(f / p.O);
        if (pretest(p, T, f, k, X0, X1, X2, run.lmv)) {
          const Proj q = project(p, T + 16 * k, X0, X1, X2,
                                 p.obs_uv[2 * f], p.obs_uv[2 * f + 1]);
          const float chi2 = q.r0 * q.r0 + q.r1 * q.r1;
          const float nrm = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
          c += huber(chi2, nrm, p.huber_delta);
        }
      }
    }
  }
  if (n_valid) *n_valid = enough ? cnt : 0;
  return warp_sum(c);
}

// The segmented inclusive scan of v over lanes whose run starts at lane
// `head` (the sum of a run's values ends in its last lane).
__device__ __forceinline__ float run_scan(float v, int head, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(FULL, v, off);
    if (lane - off >= head) v += t;
  }
  return v;
}

// Phase A for landmark l (a warp): its sums into the warp's buffer B (bl,
// cost, and per keyframe Wpl, A = Wpl Hll^-1, Hpp's and bp's shares), its
// record (Hll^-1, bl, Wpl) into global memory; returns the keyframes with
// a share (bit k).
__device__ unsigned landmark_terms(const Problem& p, const Layout& g,
                                   const float* T, int l, const float* X,
                                   float* B, float* rec, int lane) {
  const Run run = landmark_run(p, l);
  const float X0 = X[0], X1 = X[1], X2 = X[2];
  const bool enough = count_valid(p, T, run, X0, X1, X2, lane) >= 2;
  float hll[9], bls[3], c = 0.0f;
#pragma unroll
  for (int q = 0; q < 9; ++q) hll[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 3; ++q) bls[q] = 0.0f;
  unsigned mask = 0;
  for (long long base = run.beg; enough && base < run.end; base += 32) {
    const long long o = base + lane;
    const bool in = o < run.end;
    int k = 0;
    bool valid = false;
    float r0 = 0.0f, r1 = 0.0f, Jp0[6], Jp1[6], Jl0[3], Jl1[3], w = 0.0f;
#pragma unroll
    for (int q = 0; q < 6; ++q) Jp0[q] = Jp1[q] = 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) Jl0[q] = Jl1[q] = 0.0f;
    if (in) {
      const long long f = p.order[o];
      k = (int)(f / p.O);
      const float* Tk = T + 16 * k;
      valid = pretest(p, T, f, k, X0, X1, X2, run.lmv);
      if (valid) {
        const Proj q = project(p, Tk, X0, X1, X2, p.obs_uv[2 * f],
                               p.obs_uv[2 * f + 1]);
        r0 = q.r0;
        r1 = q.r1;
        Jp0[0] = q.a; Jp0[1] = 0.0f; Jp0[2] = q.c;
        Jp0[3] = q.c * q.y; Jp0[4] = q.a * q.z - q.c * q.x;
        Jp0[5] = -(q.a * q.y);
        Jp1[0] = 0.0f; Jp1[1] = q.b; Jp1[2] = q.d;
        Jp1[3] = q.d * q.y - q.b * q.z; Jp1[4] = -(q.d * q.x);
        Jp1[5] = q.b * q.x;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Jl0[j] = q.a * Tk[j] + q.c * Tk[8 + j];
          Jl1[j] = q.b * Tk[4 + j] + q.d * Tk[8 + j];
        }
        const float chi2 = r0 * r0 + r1 * r1;
        const float nrm = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
        const float wh = p.huber_delta / nrm;
        w = wh > 1.0f ? 1.0f : wh;
        c += huber(chi2, nrm, p.huber_delta);
        float JlW0[3], JlW1[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          JlW0[j] = Jl0[j] * w;
          JlW1[j] = Jl1[j] * w;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            hll[3 * i + j] += Jl0[i] * JlW0[j] + Jl1[i] * JlW1[j];
          bls[i] += -(JlW0[i] * r0 + JlW1[i] * r1);
        }
      }
    }
    // a keyframe's observations of the landmark are consecutive: runs of
    // equal keys, each summed into its last lane
    const int key = in ? k : -1 - lane;
    const int prev = __shfl_up_sync(FULL, key, 1);
    const int next = __shfl_down_sync(FULL, key, 1);
    const bool head = lane == 0 || prev != key;
    const bool tail = lane == 31 || next != key;
    const bool dup = __any_sync(FULL, in && !head);
    const unsigned round_mask = __reduce_or_sync(FULL, in ? 1u << k : 0u);
    int start = head ? lane : 0;
    if (dup) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, start, off);
        if (lane >= off && t > start) start = t;
      }
    }
    const bool write = in && tail;
    const bool add = (mask >> k) & 1u;
    float JpW0[6], JpW1[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      JpW0[i] = Jp0[i] * w;
      JpW1[i] = Jp1[i] * w;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float v = valid ? JpW0[i] * Jl0[j] + JpW1[i] * Jl1[j] : 0.0f;
        if (dup) v = run_scan(v, start, lane);
        float* dst = B + g.wpl + 18 * k + 3 * i + j;
        if (write) *dst = add ? *dst + v : v;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float v = valid ? Jp0[i] * JpW0[j] + Jp1[i] * JpW1[j] : 0.0f;
        if (dup) v = run_scan(v, start, lane);
        float* dst = B + g.lhpp + 36 * k + 6 * i + j;
        if (write) *dst = add ? *dst + v : v;
      }
      float v = valid ? -(JpW0[i] * r0 + JpW1[i] * r1) : 0.0f;
      if (dup) v = run_scan(v, start, lane);
      float* dst = B + g.lbp + 6 * k + i;
      if (write) *dst = add ? *dst + v : v;
    }
    mask |= round_mask;
    __syncwarp();
  }
  float Hd[3][3], Hi[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float h = warp_sum(hll[3 * i + j]);
      Hd[i][j] = i == j ? h + p.damping : h;
      Hi[i][j] = i == j ? 1.0f : 0.0f;
    }
  lu_small<3, 3>(Hd, Hi);
  float bl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) bl[i] = warp_sum(bls[i]);
  c = warp_sum(c);
  if (lane == 0) {
    B[0] = bl[0]; B[1] = bl[1]; B[2] = bl[2]; B[3] = c;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) rec[3 * i + j] = Hi[i][j];
    rec[9] = bl[0]; rec[10] = bl[1]; rec[11] = bl[2];
  }
  __syncwarp();
  for (int idx = lane; idx < 6 * g.W; idx += 32) {
    const int k = idx / 6;
    if (!((mask >> k) & 1u)) continue;
    const float* wp = B + g.wpl + 3 * idx;
    float* ap = B + g.a + 3 * idx;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      ap[m] = wp[0] * Hi[0][m] + wp[1] * Hi[1][m] + wp[2] * Hi[2][m];
      rec[12 + 3 * idx + m] = wp[m];
    }
  }
  __syncwarp();
  return mask;
}

// Entry e of the system's sums, added over the batch's `live` landmarks in
// order (the buffers of warps 0, 1, ...).
__device__ float accumulate(const Layout& g, int e, float acc,
                            const float* lmb, const unsigned* masks,
                            int live) {
  if (e < g.bp) {
    const int k = e / 36, q = e % 36;
    for (int j = 0; j < live; ++j)
      if ((masks[j] >> k) & 1u) acc += lmb[j * g.lmb + g.lhpp + 36 * k + q];
  } else if (e < g.soff) {
    const int r = e - g.bp, k = r / 6;
    for (int j = 0; j < live; ++j)
      if ((masks[j] >> k) & 1u) acc += lmb[j * g.lmb + g.lbp + r];
  } else if (e < g.boff) {
    const int r = (e - g.soff) / g.n, c = (e - g.soff) % g.n;
    const int k = r / 6, k2 = c / 6;
    for (int j = 0; j < live; ++j)
      if (((masks[j] >> k) & 1u) && ((masks[j] >> k2) & 1u)) {
        const float* A = lmb + j * g.lmb + g.a + 3 * r;
        const float* P = lmb + j * g.lmb + g.wpl + 3 * c;
        acc = fmaf(A[2], P[2], fmaf(A[1], P[1], fmaf(A[0], P[0], acc)));
      }
  } else if (e < g.cost) {
    const int r = e - g.boff, k = r / 6;
    for (int j = 0; j < live; ++j)
      if ((masks[j] >> k) & 1u) {
        const float* A = lmb + j * g.lmb + g.a + 3 * r;
        const float* bl = lmb + j * g.lmb;
        acc = fmaf(A[2], bl[2], fmaf(A[1], bl[1], fmaf(A[0], bl[0], acc)));
      }
  } else {
    for (int j = 0; j < live; ++j) acc += lmb[j * g.lmb + 3];
  }
  return acc;
}

// x := M^-1 b for the augmented n x (n + 1) system in shared memory (column
// n is b), by LU with partial pivoting, the whole block; M is overwritten.
__device__ void lu_solve_block(float* M, int n, float* x, int* s_piv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = n + 1;
  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      float best = -1.0f;
      int piv = n;
      for (int i = k + lane; i < n; i += 32) {
        const float v = fabsf(M[i * ld + k]);
        if (v > best) { best = v; piv = i; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int op = __shfl_xor_sync(FULL, piv, off);
        if (ob > best || (ob == best && op < piv)) { best = ob; piv = op; }
      }
      if (lane == 0) *s_piv = piv < n ? piv : k;
    }
    __syncthreads();
    const int piv = *s_piv;
    if (piv != k) {
      for (int j = k + tid; j <= n; j += THREADS) {
        const float t = M[k * ld + j];
        M[k * ld + j] = M[piv * ld + j];
        M[piv * ld + j] = t;
      }
      __syncthreads();
    }
    const int w = n - k;
    const int cnt = (n - k - 1) * w;
    for (int idx = tid; idx < cnt; idx += THREADS) {
      const int i = k + 1 + idx / w, j = k + 1 + idx % w;
      const float l = M[i * ld + k] / M[k * ld + k];
      M[i * ld + j] = fmaf(-l, M[k * ld + j], M[i * ld + j]);
    }
    __syncthreads();
  }
  if (warp == 0) {
    for (int i = n - 1; i >= 0; --i) {
      float s = 0.0f;
      for (int j = i + 1 + lane; j < n; j += 32)
        s = fmaf(M[i * ld + j], x[j], s);
      s = warp_sum(s);
      if (lane == 0) x[i] = (M[i * ld + n] - s) / M[i * ld + i];
      __syncwarp();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
window_gn_kernel(Problem p, Outputs out, Work wk) {
  extern __shared__ float sm[];
  __shared__ unsigned s_mask[WARPS];
  __shared__ float s_lm[CHUNK];
  __shared__ int s_cnt[CHUNK];
  __shared__ int s_piv, s_ok, s_accept;
  __shared__ float s_cost_prev, s_improve;

  cg::grid_group grid = cg::this_grid();
  const Layout g = layout(p.W, p.L);
  const int W = p.W, n = g.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool prior = p.prior_w > 0.0f;
  float* sT = sm;                 // the poses
  float* sNew = sT + 16 * W;      // the step's poses
  float* sInv = sNew + 16 * W;    // the input poses' inverses
  float* sDev = sInv + 16 * W;    // the prior's deviations
  float* sX = sDev + 6 * W;       // the step
  float* acc = sm + g.pose_floats;
  float* lmb = acc + g.E;
  float* M = acc;

  // the landmarks of chunk c's batch b, for warp `warp`
  const auto landmark = [&](int c, int b) {
    return c * CHUNK + b * WARPS + warp;
  };
  const auto live_in = [&](int first, int most) {
    const int m = p.L - first;
    return m < 0 ? 0 : (m < most ? m : most);
  };

  // start: the poses, their inverses; the landmarks into the output, and
  // the cost and valid observations at the input
  if (tid < 16 * W) sT[tid] = p.poses[tid];
  __syncthreads();
  if (tid < W) inverse4(sT + 16 * tid, sInv + 16 * tid);
  for (int c = blockIdx.x; c < g.nchunks; c += gridDim.x) {
    for (int b = 0; b < BATCHES; ++b) {
      const int l = landmark(c, b);
      if (l < p.L) {
        const float* X = p.landmarks + 3 * l;
        if (lane < 3) out.landmarks[3 * l + lane] = X[lane];
        int nv;
        const float cost = landmark_cost(p, sT, landmark_run(p, l), X[0],
                                         X[1], X[2], lane, &nv);
        if (lane == 0) {
          s_lm[l - c * CHUNK] = cost;
          s_cnt[l - c * CHUNK] = nv;
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      int cn = 0;
      const int live = live_in(c * CHUNK, CHUNK);
      for (int j = 0; j < live; ++j) { s += s_lm[j]; cn += s_cnt[j]; }
      wk.cpart[c] = s;
      wk.npart[c] = cn;
    }
    __syncthreads();
  }
  grid.sync();
  if (blockIdx.x == 0 && warp == 0) {
    const float c0 = chunk_sum(wk.cpart, g.nchunks, lane);
    int nv = 0;
    for (int c = lane; c < g.nchunks; c += 32) nv += wk.npart[c];
    nv = warp_sum(nv);
    if (lane == 0) { *out.cost_initial = c0; *out.n_obs = nv; }
  }

  int it = 0;
  bool go = p.iters > 0;
  while (go) {
    // A. the landmarks' terms and the chunks' partial sums
    for (int c = blockIdx.x; c < g.nchunks; c += gridDim.x) {
      for (int e = tid; e < g.E; e += THREADS) acc[e] = 0.0f;
      for (int b = 0; b < BATCHES; ++b) {
        const int l = landmark(c, b);
        if (l < p.L) {
          const unsigned mask = landmark_terms(
              p, g, sT, l, out.landmarks + 3 * l, lmb + warp * g.lmb,
              wk.lmstore + (size_t)l * g.lms, lane);
          if (lane == 0) { s_mask[warp] = mask; wk.lmmask[l] = mask; }
        }
        __syncthreads();
        const int live = live_in(c * CHUNK + b * WARPS, WARPS);
        for (int e = tid; e < g.E; e += THREADS)
          acc[e] = accumulate(g, e, acc[e], lmb, s_mask, live);
        __syncthreads();
      }
      for (int e = tid; e < g.E; e += THREADS)
        wk.part[(size_t)e * g.nchunks + c] = acc[e];
    }
    grid.sync();
    // the totals: a warp an entry
    for (int e = blockIdx.x * WARPS + warp; e < g.E; e += gridDim.x * WARPS) {
      const float v = chunk_sum(wk.part + (size_t)e * g.nchunks, g.nchunks,
                                lane);
      if (lane == 0) wk.total[e] = v;
    }
    grid.sync();
    // B. every block: the reduced system, its solve and the step's poses
    const float* tot = wk.total;
    if (prior && tid < W)
      se3_log_of_product(sT + 16 * tid, sInv + 16 * tid, sDev + 6 * tid);
    __syncthreads();
    for (int idx = tid; idx < n * n; idx += THREADS) {
      const int r = idx / n, cc = idx % n;
      const int k = r / 6, k2 = cc / 6;
      float s = (k == k2 ? tot[g.hpp + 36 * k + 6 * (r % 6) + cc % 6] : 0.0f)
                - tot[g.soff + idx];
      if (r == cc) {
        if (k < p.n_fixed) s = s + PIN;
        s = s + p.damping;
        if (prior) s = s + p.prior_w;
      }
      M[r * (n + 1) + cc] = s;
    }
    for (int r = tid; r < n; r += THREADS) {
      float bv = tot[g.bp + r] - tot[g.boff + r];
      if (prior) bv = bv - p.prior_w * sDev[r];
      M[r * (n + 1) + n] = bv;
    }
    if (tid == 0)
      s_cost_prev = prior ? tot[g.cost] + prior_cost(sDev, n, p.prior_w)
                          : tot[g.cost];
    __syncthreads();
    lu_solve_block(M, n, sX, &s_piv);
    if (tid == 0) {
      bool ok = true;
      for (int r = 0; r < n; ++r) ok = ok && isfinite(sX[r]);
      s_ok = ok;
    }
    __syncthreads();
    if (tid < n) {
      float v = s_ok ? sX[tid] : 0.0f;
      if (tid / 6 < p.n_fixed) v = 0.0f;
      sX[tid] = v;
    }
    __syncthreads();
    if (tid < W) {
      for (int q = 0; q < 16; ++q) sNew[16 * tid + q] = sT[16 * tid + q];
      se3_update(sX + 6 * tid, sNew + 16 * tid);
    }
    __syncthreads();
    // C. back-substitution and the two landmark costs
    for (int c = blockIdx.x; c < g.nchunks; c += gridDim.x) {
      for (int b = 0; b < BATCHES; ++b) {
        const int l = landmark(c, b);
        if (l >= p.L) continue;
        const Run run = landmark_run(p, l);
        const float* rec = wk.lmstore + (size_t)l * g.lms;
        const unsigned mask = wk.lmmask[l];
        const float* X = out.landmarks + 3 * l;
        const float X0 = X[0], X1 = X[1], X2 = X[2];
        float s[3] = {0.0f, 0.0f, 0.0f};
        for (int k = 0; k < W; ++k) {
          if (!((mask >> k) & 1u)) continue;
          for (int i = 0; i < 6; ++i) {
            const float* wp = rec + 12 + 18 * k + 3 * i;
            const float dx = sX[6 * k + i];
#pragma unroll
            for (int m = 0; m < 3; ++m) s[m] += wp[m] * dx;
          }
        }
        float rhs[3], dxl[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) rhs[m] = rec[9 + m] - s[m];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          float v = rec[3 * m] * rhs[0] + rec[3 * m + 1] * rhs[1]
                    + rec[3 * m + 2] * rhs[2];
          if (!(s_ok && run.lmv)) v = 0.0f;
          dxl[m] = v < -5.0f ? -5.0f : (v > 5.0f ? 5.0f : v);
        }
        const float C0 = X0 + dxl[0], C1 = X1 + dxl[1], C2 = X2 + dxl[2];
        const float lmA = landmark_cost(p, sNew, run, C0, C1, C2, lane,
                                        nullptr);
        const float lmB = landmark_cost(p, sNew, run, X0, X1, X2, lane,
                                        nullptr);
        if (lane == 0) {
          wk.cand[3 * l] = C0; wk.cand[3 * l + 1] = C1;
          wk.cand[3 * l + 2] = C2;
          wk.better[l] = lmA <= lmB;
          // torch.minimum: NaN if either is NaN
          s_lm[l - c * CHUNK] = (lmA != lmA || lmB != lmB)
              ? lmA + lmB : (lmB < lmA ? lmB : lmA);
        }
      }
      __syncthreads();
      if (tid == 0) {
        float sum = 0.0f;
        const int live = live_in(c * CHUNK, CHUNK);
        for (int j = 0; j < live; ++j) sum += s_lm[j];
        wk.cpart[c] = sum;
      }
      __syncthreads();
    }
    grid.sync();
    // D. every block: the step's acceptance and the exit; the step applied
    if (prior && tid < W)
      se3_log_of_product(sNew + 16 * tid, sInv + 16 * tid, sDev + 6 * tid);
    __syncthreads();
    if (warp == 0) {
      float mixed = chunk_sum(wk.cpart, g.nchunks, lane);
      if (lane == 0) {
        if (prior) mixed = mixed + prior_cost(sDev, n, p.prior_w);
        const float cp = s_cost_prev;
        const bool accept = mixed < cp;
        const float cl = cp < 1e-12f ? 1e-12f : cp;
        s_accept = accept;
        s_improve = accept ? (cp - mixed) / cl : 0.0f;
      }
    }
    __syncthreads();
    if (s_accept) {
      if (tid < 16 * W) sT[tid] = sNew[tid];
      for (int c = blockIdx.x; c < g.nchunks; c += gridDim.x)
        for (int b = 0; b < BATCHES; ++b) {
          const int l = landmark(c, b);
          if (l < p.L && lane < 3 && wk.better[l])
            out.landmarks[3 * l + lane] = wk.cand[3 * l + lane];
        }
    }
    ++it;
    go = it < p.iters && s_improve > p.rel_tol;
    __syncthreads();
  }

  // end: the cost at the final state
  for (int c = blockIdx.x; c < g.nchunks; c += gridDim.x) {
    for (int b = 0; b < BATCHES; ++b) {
      const int l = landmark(c, b);
      if (l < p.L) {
        const float* X = out.landmarks + 3 * l;
        const float cost = landmark_cost(p, sT, landmark_run(p, l), X[0],
                                         X[1], X[2], lane, nullptr);
        if (lane == 0) s_lm[l - c * CHUNK] = cost;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      const int live = live_in(c * CHUNK, CHUNK);
      for (int j = 0; j < live; ++j) s += s_lm[j];
      wk.epart[c] = s;
    }
    __syncthreads();
  }
  grid.sync();
  if (blockIdx.x == 0) {
    if (warp == 0) {
      const float c1 = chunk_sum(wk.epart, g.nchunks, lane);
      if (lane == 0) { *out.cost_final = c1; *out.n_iters = it; }
    }
    if (tid < 16 * W) out.poses[tid] = sT[tid];
  }
}

size_t shared_bytes(const Layout& g) {
  return sizeof(float) * (size_t)(g.pose_floats + g.unions);
}

}  // namespace

extern "C" long long yavo_window_gn_workspace(int W, int L) {
  if (W < 1 || W > WMAX || L < 0) return 0;
  return (long long)carve(layout(W, L), L, nullptr, nullptr);
}

extern "C" int yavo_window_gn(
    const float* poses, const unsigned char* pose_valid,
    const float* landmarks, const unsigned char* lm_valid,
    const float* obs_uv, const unsigned char* obs_valid,
    const long long* order, const long long* offsets, int W, int O, int L,
    int iters, int n_fixed, float fx, float fy, float cx, float cy,
    float huber_delta, float damping, float rel_tol, float prior_w,
    float* out_poses, float* out_landmarks, float* out_cost_initial,
    float* out_cost_final, long long* out_n_obs, int* out_iters,
    void* workspace, void* stream) {
  if (W < 1 || W > WMAX || O < 0 || L < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Layout g = layout(W, L);
  Problem p{poses, pose_valid, landmarks, lm_valid, obs_uv, obs_valid,
            order, offsets, W, O, L, iters, n_fixed, fx, fy, cx, cy,
            huber_delta, damping, rel_tol, prior_w};
  Outputs o{out_poses, out_landmarks, out_cost_initial, out_cost_final,
            out_n_obs, out_iters};
  Work wk;
  carve(g, L, (char*)workspace, &wk);
  const size_t smem = shared_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      window_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, window_gn_kernel, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // as many blocks as chunks, at most what the card holds at once (the
  // grid barrier needs every block resident)
  const int grid = g.nchunks < n_sm * per_sm ? g.nchunks : n_sm * per_sm;
  void* args[] = {&p, &o, &wk};
  err = cudaLaunchCooperativeKernel((const void*)window_gn_kernel,
                                    dim3(grid), dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
