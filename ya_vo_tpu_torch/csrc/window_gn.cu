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
// costs, the exit), so its time is that chain's latency times the
// iterations the data needs. The design shortens each link of the chain
// and keeps every sum's order, so its bits are those of the first K5 (a
// grid of 256-thread blocks, a block-wide LU), which
// tests/torch_data/window_gn/k5_bits.npz records.
//
// The design: one cooperative launch of as many co-resident blocks of 512
// threads (one a multiprocessor: 128 registers a thread) as the landmarks
// need, landmark-major. The landmarks are cut into chunks of 32 (2 batches
// of 16, one landmark a warp), chunk c taken by block c mod gridDim.x; a
// landmark stays with its warp through every phase, so only that warp ever
// reads or writes its position.
//  A. Each warp takes one landmark a batch: its observations (a CSR run,
//     ascending flat order) in rounds of 32 lanes, their terms and, in the
//     same pass, their count of valid ones (with fewer than 2 the terms
//     are dropped), and the landmark's sums: Hll, bl and its cost by
//     a butterfly over lanes, and per keyframe Wpl, Hpp's and bp's shares
//     by a segmented scan over a keyframe's run (a landmark seen twice in
//     one keyframe) into shared memory; then Hll^-1 and A = Wpl Hll^-1.
//     After both batches (a buffer a landmark of the chunk) the block adds
//     the chunk's 32 landmarks, in order, into its partial sums: a thread
//     takes a 3x3 tile of S_off (one keyframe pair; its 9 sums in
//     registers, each landmark's 3 A rows and 3 Wpl columns read once) or
//     one entry of Hpp, bp, b_red's terms or the cost, and writes its sums
//     to global memory, one column a chunk.
//  Grid barrier. Each warp of the grid adds an entry's chunk partials in a
//     fixed order (lane j takes chunks j, j + 32, ..., then a butterfly).
//  Grid barrier.
//  B. Every block assembles the 6W x 6W system from the totals in its
//     shared memory, and its warp 0 alone solves it (`lu_solve_warp`), with
//     __syncwarp as the only sync inside, while the other warps wait at one
//     block barrier; the same bits in every block (the same code on the
//     same data), so no broadcast is needed; then the step's poses. A
//     block-wide LU (the first kernel's) takes 3 block barriers a step.
//  C. Each warp back-substitutes its landmarks and evaluates lmA and lmB
//     in one pass over the landmark's observations; the chunk's sum of
//     min(lmA, lmB) goes to global memory. The last warp first takes the
//     prior's deviations of the step's poses, which D needs (the poses'
//     own are taken once, at the first iteration, and an accepted step
//     hands its deviations on).
//  Grid barrier.
//  D. Every block adds the chunks' sums, decides the step and the exit,
//     and applies the step (the poses in its shared memory; each warp its
//     landmarks).
// No float atomics: every sum is taken in a fixed order (a lane's terms in
// round order, then a butterfly; a chunk's landmarks in order; the chunks
// as above), and the chunk partition depends on L alone, so two calls give
// the same bits on any card. Which thread takes a sum, and when, does not
// change it. The build's -fmad=false makes every multiply and add round on
// its own, as in the plain version's elementwise terms; the 6W x 6W LU's
// updates and back-substitution and the products summed into S and b_red
// are explicit fused multiply-adds (fmaf), as LAPACK's getrf and a GEMM
// compute them for the plain version and JAX. Where a window's last
// improvement sits near rel_tol, its iteration count follows such rounding
// in every float32 version (PERF.md). The landmark cost that enters
// cost_prev and the one that enters mixed are summed by the same code in
// the same order, so a step that changes nothing is not taken.
//
// Not used, and why: the tensor cores (wgmma takes no float32 input, the
// geometry stays in float32 with TF32 off, and splitting into TF32 parts
// would change the bits; the products are 6x3 blocks besides); TMA (the
// observations are a gather through the CSR order, not a tile); a single
// thread-block cluster in place of the grid (the grid barriers and the
// partials' round trip are a small share of the time, PERF.md, while 16
// blocks would take 8 times the landmarks a warp in phases A and C).
// The LU's matrix stays in shared memory rather than registers: rows held
// in registers need every step unrolled (static indices), and the row
// exchange then a select over every row, and with 512 threads a block a
// thread has 128 registers; one warp's step is a chain of ~650 cycles
// (the next pivot's reductions, the division, the first quad) besides its
// share of the update (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#ifdef YAVO_K5_PHASES
// Built with -DYAVO_K5_PHASES (port_window_gn.py phases): at PHASE(i),
// thread 0 of each block adds the clock64() cycles since its last mark to
// k5_phase_cycles[block][i]; yavo_window_gn_phases reads and zeroes them.
constexpr int PHASE_BLOCKS = 256, NPHASES = 12;
__device__ unsigned long long k5_phase_cycles[PHASE_BLOCKS][NPHASES];
__shared__ long long k5_phase_t;
#define PHASE_INIT if (threadIdx.x == 0) k5_phase_t = clock64();
#define PHASE(i) if (threadIdx.x == 0 && blockIdx.x < PHASE_BLOCKS) { \
    const long long t_ = clock64(); \
    k5_phase_cycles[blockIdx.x][i] += t_ - k5_phase_t; k5_phase_t = t_; }
#else
#define PHASE_INIT
#define PHASE(i)
#endif

namespace {

constexpr int THREADS = 512;
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
// [W][6][6], bp [W][6], S_off [6W][6W], b_off [6W], the cost), a
// landmark's buffer in shared memory, one for each of a chunk's landmarks
// (bl, cost, then Wpl, A = Wpl Hll^-1, Hpp's and bp's shares, each
// [W][...]) and a landmark's record in global memory (Hll^-1, bl, Wpl).
struct Layout {
  int W, n, ld, nchunks;
  int hpp, bp, soff, boff, cost, E;
  int wpl, a, lhpp, lbp, lmb;
  int lms;
  int pose_floats, unions;
};

// The row stride of the augmented n x (n + 1) system in shared memory: a
// multiple of 4 floats (rows 16-byte aligned) with an odd number of
// 16-byte quads, so 8 lanes reading 16 bytes each from 8 consecutive rows
// touch 8 distinct groups of 4 banks.
__host__ __device__ inline int system_ld(int n) {
  const int ld = (n + 1 + 3) / 4 * 4;
  return (ld / 4) % 2 ? ld : ld + 4;
}

__host__ __device__ inline Layout layout(int W, int L) {
  Layout g;
  g.W = W;
  g.n = 6 * W;
  g.ld = system_ld(g.n);
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
  // sT, sNew, sInv [W][16], two deviations and sX [6W], rounded to 16
  // bytes
  g.pose_floats = (3 * 16 * W + 3 * 6 * W + 3) / 4 * 4;
  const int a_phase = CHUNK * g.lmb;
  const int b_phase = g.n * g.ld;
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

// Observation (uo, vo)'s robust cost at the camera T and the point X.
__device__ __forceinline__ float obs_cost(const Problem& p, const float* T,
                                          const float* X, float uo,
                                          float vo) {
  const Proj q = project(p, T, X[0], X[1], X[2], uo, vo);
  const float chi2 = q.r0 * q.r0 + q.r1 * q.r1;
  return huber(chi2, sqrtf(chi2 < 1e-12f ? 1e-12f : chi2), p.huber_delta);
}

// The robust costs of one landmark at NX positions X[0..NX) under the same
// poses (a warp; every lane gets the same sums), in one pass over its
// observations: each position's count of valid observations and its
// lanes' terms in round order, then a butterfly; a position with fewer
// than 2 valid observations costs 0 (its terms are dropped). Its valid
// observations go to n_valid[m] where given.
template <int NX>
__device__ void landmark_costs(const Problem& p, const float* T,
                               const Run& run, const float (&X)[NX][3],
                               int lane, float (&cost)[NX],
                               int* n_valid = nullptr) {
  int cnt[NX];
  float c[NX];
#pragma unroll
  for (int m = 0; m < NX; ++m) { cnt[m] = 0; c[m] = 0.0f; }
  for (long long base = run.beg; base < run.end; base += 32) {
    const long long o = base + lane;
    bool pre[NX];
#pragma unroll
    for (int m = 0; m < NX; ++m) pre[m] = false;
    if (o < run.end) {
      const long long f = p.order[o];
      const int k = (int)(f / p.O);
      const float uo = p.obs_uv[2 * f], vo = p.obs_uv[2 * f + 1];
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        pre[m] = pretest(p, T, f, k, X[m][0], X[m][1], X[m][2], run.lmv);
        if (pre[m]) c[m] += obs_cost(p, T + 16 * k, X[m], uo, vo);
      }
    }
#pragma unroll
    for (int m = 0; m < NX; ++m) cnt[m] += __popc(__ballot_sync(FULL, pre[m]));
  }
#pragma unroll
  for (int m = 0; m < NX; ++m) {
    const bool enough = cnt[m] >= 2;
    if (n_valid) n_valid[m] = enough ? cnt[m] : 0;
    cost[m] = warp_sum(enough ? c[m] : 0.0f);
  }
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
  // one pass: the terms of every valid observation and their count; with
  // fewer than 2 the landmark has no terms (they are dropped below)
  int cnt = 0;
  float hll[9], bls[3], c = 0.0f;
#pragma unroll
  for (int q = 0; q < 9; ++q) hll[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 3; ++q) bls[q] = 0.0f;
  unsigned mask = 0;
  for (long long base = run.beg; base < run.end; base += 32) {
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
    cnt += __popc(__ballot_sync(FULL, valid));
    __syncwarp();
  }
  if (cnt < 2) {
    mask = 0;
    c = 0.0f;
#pragma unroll
    for (int q = 0; q < 9; ++q) hll[q] = 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) bls[q] = 0.0f;
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

// Entry e of the system's sums other than S_off's, added over the chunk's
// `live` landmarks in order (buffers 0, 1, ...).
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

// S_off's 3x3 tile t (rows 3 (t / (n / 3)) + 0..2, columns 3 (t % (n / 3))
// + 0..2, one keyframe pair): each entry's sum over the chunk's `live`
// landmarks in order, from 0, as `accumulate` takes it, with the tile's A
// rows and Wpl columns read once a landmark; written to the chunk's column
// of the partials.
__device__ void accumulate_tile(const Layout& g, int t, const float* lmb,
                                const unsigned* masks, int live,
                                float* part, int c) {
  const int m = g.n / 3;
  const int r0 = 3 * (t / m), c0 = 3 * (t % m);
  const int k = r0 / 6, k2 = c0 / 6;
  float s[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) s[a][b] = 0.0f;
  // the landmarks with a share in both keyframes, read at once
  unsigned both = 0;
  for (int j = 0; j < live; ++j)
    both |= (((masks[j] >> k) & (masks[j] >> k2)) & 1u) << j;
  for (; both; both &= both - 1) {
    const int j = __ffs(both) - 1;
    const float* A = lmb + j * g.lmb + g.a + 3 * r0;
    const float* P = lmb + j * g.lmb + g.wpl + 3 * c0;
    float av[9], pv[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) { av[q] = A[q]; pv[q] = P[q]; }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        s[a][b] = fmaf(av[3 * a + 2], pv[3 * b + 2],
                       fmaf(av[3 * a + 1], pv[3 * b + 1],
                            fmaf(av[3 * a], pv[3 * b], s[a][b])));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      part[(size_t)(g.soff + (r0 + a) * g.n + c0 + b) * g.nchunks + c] =
          s[a][b];
}

// Chunk c's partial sums of every entry over its `live` landmarks in order
// (buffer j of lmb holds the chunk's landmark j), straight to the chunk's
// column of `part`: a thread takes work items tid, tid + THREADS, ...:
// S_off's tiles first, then the other entries one by one.
__device__ void chunk_partials(const Layout& g, const float* lmb,
                               const unsigned* masks, int live, int tid,
                               float* part, int c) {
  const int tiles = (g.n / 3) * (g.n / 3);
  const int items = tiles + g.soff + (g.E - g.boff);
  for (int it = tid; it < items; it += THREADS) {
    if (it < tiles) {
      accumulate_tile(g, it, lmb, masks, live, part, c);
    } else {
      const int i = it - tiles;
      const int e = i < g.soff ? i : g.boff + (i - g.soff);
      part[(size_t)e * g.nchunks + c] = accumulate(g, e, 0.0f, lmb, masks,
                                                   live);
    }
  }
}

// The first largest of the lanes' candidates (the first largest |value| of
// each lane's rows, `at` = n where a lane has none): every lane gets the
// row `at` (n where no lane has one) and its signed value `val`. A |value|'s
// bits order as the value does, so two warp reductions find it: the
// largest key (bits + 1; 0 for none, so a NaN is never picked) and, among
// the lanes that hold it, the smallest row; ties go to the first row, as in
// LAPACK's getrf.
__device__ __forceinline__ void first_largest(float best, int& at, float& val,
                                              int n) {
  const unsigned key = at < n ? __float_as_uint(best) + 1u : 0u;
  const unsigned top = __reduce_max_sync(FULL, key);
  const unsigned row = __reduce_min_sync(
      FULL, top != 0u && key == top ? (unsigned)at : (unsigned)n);
  const int src = top != 0u ? (int)(row & 31u) : 0;
  val = __shfl_sync(FULL, val, src);
  at = (int)row;
}

// Step k of the warp's LU (`lu_solve_warp`) for rows in slots R0..NR-1
// (the slots before R0 hold no row past k): the exchange of rows k and the
// pivot's, the multipliers, and the update of columns k + 1 .. n, with the
// first largest of column k + 1 for step k + 1 in (at, val).
template <int NR, int R0>
__device__ __forceinline__ void lu_step(float* M, int n, int ld, int k,
                                        int lane, float (&ck)[NR], int& at,
                                        float& val) {
  constexpr int U = NR <= 2 ? 3 : 1;         // quads read ahead at once
  const int nq = ld / 4;
  // the pivot: row `piv` and its value `d`, or row k itself if no row is a
  // candidate (every |value| NaN)
  const int piv = at < n ? at : k;
  float own = 0.0f;
#pragma unroll
  for (int r = 0; r < NR; ++r) if ((k >> 5) == r) own = ck[r];
  const float okk = __shfl_sync(FULL, own, k & 31);   // row k's M[k][k]
  const float d = at < n ? val : okk;
  // the multipliers, from registers, while the rows are exchanged
  float l[NR];
  bool act[NR];
#pragma unroll
  for (int r = R0; r < NR; ++r) {
    const int i = lane + 32 * r;
    act[r] = i > k && i < n;
    // row piv takes the old row k
    l[r] = act[r] ? (i == piv ? okk : ck[r]) / d : 0.0f;
  }
  if (piv != k) {
    float4* qk = reinterpret_cast<float4*>(M + k * ld);
    float4* qp = reinterpret_cast<float4*>(M + piv * ld);
    for (int q = lane; q < nq; q += 32) {
      const float4 t = qk[q];
      qk[q] = qp[q];
      qp[q] = t;
    }
    __syncwarp();
  }
  const float4* rk = reinterpret_cast<const float4*>(M + k * ld);
  float4* rows[NR];
#pragma unroll
  for (int r = R0; r < NR; ++r)
    rows[r] = reinterpret_cast<float4*>(M + (act[r] ? lane + 32 * r : k) * ld);
  // the quad holding column k + 1 (its columns at or before k are dead and
  // take garbage): column k + 1 stays in ck, and gives this lane's
  // candidate for the next pivot, its rows in ascending order
  const int q0 = (k + 1) >> 2, c1 = (k + 1) & 3;
  float best = -1.0f;
  at = n;
  val = 0.0f;
  {
    const float4 pk = rk[q0];
    float4 v[NR];
#pragma unroll
    for (int r = R0; r < NR; ++r) v[r] = rows[r][q0];
#pragma unroll
    for (int r = R0; r < NR; ++r) {
      v[r].x = fmaf(-l[r], pk.x, v[r].x);
      v[r].y = fmaf(-l[r], pk.y, v[r].y);
      v[r].z = fmaf(-l[r], pk.z, v[r].z);
      v[r].w = fmaf(-l[r], pk.w, v[r].w);
      if (act[r]) rows[r][q0] = v[r];
      const float c = c1 == 0 ? v[r].x : c1 == 1 ? v[r].y
                      : c1 == 2 ? v[r].z : v[r].w;
      const bool better = act[r] && fabsf(c) > best;
      ck[r] = act[r] ? c : ck[r];
      best = better ? fabsf(c) : best;
      at = better ? lane + 32 * r : at;
      val = better ? c : val;
    }
  }
  // the other quads up to the row's end (the padding past n is dead), U at
  // a time, every read before the writes, then one at a time
  int q = q0 + 1;
  for (; q + U <= nq; q += U) {
    float4 pk[U], v[U][NR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pk[u] = rk[q + u];
#pragma unroll
      for (int r = R0; r < NR; ++r) v[u][r] = rows[r][q + u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = R0; r < NR; ++r) {
        v[u][r].x = fmaf(-l[r], pk[u].x, v[u][r].x);
        v[u][r].y = fmaf(-l[r], pk[u].y, v[u][r].y);
        v[u][r].z = fmaf(-l[r], pk[u].z, v[u][r].z);
        v[u][r].w = fmaf(-l[r], pk[u].w, v[u][r].w);
        if (act[r]) rows[r][q + u] = v[u][r];
      }
  }
  for (; q < nq; ++q) {
    const float4 pk = rk[q];
    float4 v[NR];
#pragma unroll
    for (int r = R0; r < NR; ++r) v[r] = rows[r][q];
#pragma unroll
    for (int r = R0; r < NR; ++r) {
      v[r].x = fmaf(-l[r], pk.x, v[r].x);
      v[r].y = fmaf(-l[r], pk.y, v[r].y);
      v[r].z = fmaf(-l[r], pk.z, v[r].z);
      v[r].w = fmaf(-l[r], pk.w, v[r].w);
      if (act[r]) rows[r][q] = v[r];
    }
  }
  first_largest(best, at, val, n);
  __syncwarp();
}

// x := M^-1 b for the augmented n x (n + 1) system in shared memory (rows
// `ld` floats apart, column n is b), by right-looking LU with partial
// pivoting (the first largest pivot, as LAPACK's getrf picks it) and
// back-substitution, on one warp with __syncwarp as its only sync; M is
// overwritten. Lane j owns rows j + 32 r (r < NR). Step k (`lu_step`): the
// rows k and the pivot's are exchanged whole (16 bytes a lane); each lane
// divides its rows' M[i][k], which it holds in registers from the step
// before, by the pivot, once a row; it updates column k + 1 first, keeping
// the values, and the other columns 4 at a time (one 16-byte read and
// write a row); the first largest of column k + 1 is the next pivot.
// Back-substitution: lane j adds the terms j + 32 c of row i in order with
// fmaf, then a butterfly; every lane divides and holds x[i], lane 0 stores
// it; the next row's coefficients and older x are read before that
// division. Returns whether every x[i] is finite.
template <int NR>
__device__ bool lu_solve_warp(float* M, int n, int ld, float* x, int lane) {
  // step 0's pivot, and this lane's rows' column 0
  float ck[NR];
  float best = -1.0f, val = 0.0f;
  int at = n;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = lane + 32 * r;
    ck[r] = i < n ? M[i * ld] : 0.0f;
    if (i < n && fabsf(ck[r]) > best) {
      best = fabsf(ck[r]); at = i; val = ck[r];
    }
  }
  first_largest(best, at, val, n);
  // slot r holds rows past k while k < 32 r + 31; step n - 1 has nothing
  // to exchange or update
  int k = 0;
  for (; k < n - 1 && k < 31; ++k)
    lu_step<NR, 0>(M, n, ld, k, lane, ck, at, val);
  if (NR > 1)
    for (; k < n - 1 && k < 63; ++k)
      lu_step<NR, (NR > 1 ? 1 : 0)>(M, n, ld, k, lane, ck, at, val);
  if (NR > 2)
    for (; k < n - 1; ++k)
      lu_step<NR, (NR > 2 ? 2 : 0)>(M, n, ld, k, lane, ck, at, val);
  PHASE(5)
  bool ok = true;
  float xprev = 0.0f;
  // row i's coefficients and the x it reads besides x[i + 1]
  float a[NR], xv[NR];
  auto fetch = [&](int i) {
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const int j = i + 1 + lane + 32 * c;
      const bool in = j < n;
      a[c] = in ? M[i * ld + j] : 0.0f;
      xv[c] = in && !(c == 0 && lane == 0) ? x[j] : 0.0f;
    }
  };
  fetch(n - 1);
  for (int i = n - 1; i >= 0; --i) {
    const float* ri = M + i * ld;
    const float bi = ri[n], di = ri[i];
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const int j = i + 1 + lane + 32 * c;
      if (j < n) s = fmaf(a[c], c == 0 && lane == 0 ? xprev : xv[c], s);
    }
    // row i - 1 reads x[i + 1 ..] (stored) besides x[i] (lane 0, xprev)
    if (i > 0) fetch(i - 1);
    s = warp_sum(s);
    const float xi = (bi - s) / di;
    ok = ok && isfinite(xi);
    if (lane == 0) x[i] = xi;
    xprev = xi;
    __syncwarp();
  }
  return ok;
}

// Phase B's solve on one warp: x := M^-1 b (`lu_solve_warp`), the step
// zeroed unless every entry is finite and on the pinned poses, then the
// step's poses sNew = se3_exp(x_k) sT_k.
__device__ void solve_step_warp(float* M, int n, int ld, float* x,
                                int n_fixed, const float* sT, float* sNew,
                                int* s_ok, int lane) {
  bool ok;
  if (n <= 32) ok = lu_solve_warp<1>(M, n, ld, x, lane);
  else if (n <= 64) ok = lu_solve_warp<2>(M, n, ld, x, lane);
  else ok = lu_solve_warp<3>(M, n, ld, x, lane);
  for (int r = lane; r < n; r += 32) {
    float v = ok ? x[r] : 0.0f;
    if (r / 6 < n_fixed) v = 0.0f;
    x[r] = v;
  }
  if (lane == 0) *s_ok = ok;
  __syncwarp();
  const int W = n / 6;
  if (lane < W) {
    for (int q = 0; q < 16; ++q) sNew[16 * lane + q] = sT[16 * lane + q];
    se3_update(x + 6 * lane, sNew + 16 * lane);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
window_gn_kernel(Problem p, Outputs out, Work wk) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned s_mask[CHUNK];
  __shared__ float s_lm[CHUNK];
  __shared__ int s_cnt[CHUNK];
  __shared__ int s_ok, s_accept;
  __shared__ float s_cost_prev, s_improve;

  cg::grid_group grid = cg::this_grid();
  PHASE_INIT
  const Layout g = layout(p.W, p.L);
  const int W = p.W, n = g.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool prior = p.prior_w > 0.0f;
  float* sT = sm;                 // the poses
  float* sNew = sT + 16 * W;      // the step's poses
  float* sInv = sNew + 16 * W;    // the input poses' inverses
  // the prior's deviations se3_log(T T_init^-1) of the poses (sDev) and of
  // the step's poses (sDevN); an accepted step swaps them
  float* sDev = sInv + 16 * W;
  float* sDevN = sDev + 6 * W;
  float* sX = sDevN + 6 * W;      // the step
  float* lmb = sm + g.pose_floats;   // A: a landmark's buffer, a chunk's
  float* M = lmb;                    // B: the system

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
        const float Xs[1][3] = {{X[0], X[1], X[2]}};
        float cost[1];
        int nv;
        landmark_costs<1>(p, sT, landmark_run(p, l), Xs, lane, cost, &nv);
        if (lane == 0) {
          s_lm[l - c * CHUNK] = cost[0];
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
  PHASE(0)

  int it = 0;
  bool go = p.iters > 0;
  while (go) {
    // A. the landmarks' terms and the chunks' partial sums
    for (int c = blockIdx.x; c < g.nchunks; c += gridDim.x) {
      for (int b = 0; b < BATCHES; ++b) {
        const int l = landmark(c, b), j = l - c * CHUNK;
        if (l < p.L) {
          const unsigned mask = landmark_terms(
              p, g, sT, l, out.landmarks + 3 * l, lmb + j * g.lmb,
              wk.lmstore + (size_t)l * g.lms, lane);
          if (lane == 0) { s_mask[j] = mask; wk.lmmask[l] = mask; }
        }
      }
      __syncthreads();
      PHASE(1)
      chunk_partials(g, lmb, s_mask, live_in(c * CHUNK, CHUNK), tid, wk.part,
                     c);
      __syncthreads();
      PHASE(2)
    }
    grid.sync();
    // the totals: a warp an entry
    for (int e = blockIdx.x * WARPS + warp; e < g.E; e += gridDim.x * WARPS) {
      const float v = chunk_sum(wk.part + (size_t)e * g.nchunks, g.nchunks,
                                lane);
      if (lane == 0) wk.total[e] = v;
    }
    grid.sync();
    PHASE(3)
    // B. every block: the reduced system, its solve and the step's poses
    const float* tot = wk.total;
    if (prior && it == 0 && tid < W)
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
      M[r * g.ld + cc] = s;
    }
    for (int r = tid; r < n; r += THREADS) {
      float bv = tot[g.bp + r] - tot[g.boff + r];
      if (prior) bv = bv - p.prior_w * sDev[r];
      M[r * g.ld + n] = bv;
    }
    if (tid == 0)
      s_cost_prev = prior ? tot[g.cost] + prior_cost(sDev, n, p.prior_w)
                          : tot[g.cost];
    __syncthreads();
    PHASE(4)
    if (warp == 0)
      solve_step_warp(M, n, g.ld, sX, p.n_fixed, sT, sNew, &s_ok, lane);
    __syncthreads();
    PHASE(6)
    // C. the step's poses' deviations (the last warp), back-substitution
    // and the two landmark costs
    if (prior && warp == WARPS - 1 && lane < W)
      se3_log_of_product(sNew + 16 * lane, sInv + 16 * lane,
                         sDevN + 6 * lane);
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
        // lmA at the candidate, lmB at X
        const float Xs[2][3] = {{X0 + dxl[0], X1 + dxl[1], X2 + dxl[2]},
                                {X0, X1, X2}};
        float lm[2];
        landmark_costs<2>(p, sNew, run, Xs, lane, lm);
        const float lmA = lm[0], lmB = lm[1];
        if (lane == 0) {
          wk.cand[3 * l] = Xs[0][0]; wk.cand[3 * l + 1] = Xs[0][1];
          wk.cand[3 * l + 2] = Xs[0][2];
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
    PHASE(7)
    grid.sync();
    PHASE(8)
    // D. every block: the step's acceptance and the exit; the step applied
    if (warp == 0) {
      float mixed = chunk_sum(wk.cpart, g.nchunks, lane);
      if (lane == 0) {
        if (prior) mixed = mixed + prior_cost(sDevN, n, p.prior_w);
        const float cp = s_cost_prev;
        const bool accept = mixed < cp;
        const float cl = cp < 1e-12f ? 1e-12f : cp;
        s_accept = accept;
        s_improve = accept ? (cp - mixed) / cl : 0.0f;
      }
    }
    __syncthreads();
    if (s_accept) {
      float* t = sDev;
      sDev = sDevN;
      sDevN = t;
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
    PHASE(9)
  }

  // end: the cost at the final state
  for (int c = blockIdx.x; c < g.nchunks; c += gridDim.x) {
    for (int b = 0; b < BATCHES; ++b) {
      const int l = landmark(c, b);
      if (l < p.L) {
        const float* X = out.landmarks + 3 * l;
        const float Xs[1][3] = {{X[0], X[1], X[2]}};
        float cost[1];
        landmark_costs<1>(p, sT, landmark_run(p, l), Xs, lane, cost);
        if (lane == 0) s_lm[l - c * CHUNK] = cost[0];
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
#ifdef YAVO_K5_PHASES
  __syncthreads();
  PHASE(10)
#endif
}

size_t shared_bytes(const Layout& g) {
  return sizeof(float) * (size_t)(g.pose_floats + g.unions);
}

}  // namespace

#ifdef YAVO_K5_PHASES
extern "C" int yavo_window_gn_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k5_phase_cycles,
                                       sizeof(k5_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  void* ptr = nullptr;
  if ((e = cudaGetSymbolAddress(&ptr, k5_phase_cycles)) != cudaSuccess)
    return (int)e;
  return (int)cudaMemset(ptr, 0, sizeof(k5_phase_cycles));
}
#endif

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
