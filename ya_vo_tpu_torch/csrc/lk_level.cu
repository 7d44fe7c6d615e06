// Pyramidal inverse-compositional KLT (11x11 window): the whole pyramid of
// one tracker call in one launch, one warp per keypoint.
//
// Replaces the TPU kernel ya_vo_tpu/tracking/lk_pallas.py:_lk_level_kernel
// (launched by _track_level_pallas, once per level) and covers the function
// of its alternate body _lk_level_kernel_batched. The semantics are spelled
// out in ya_vo_tpu_torch/tracking/lk_cuda.py; the plain PyTorch versions
// there are track_level_plain (one level) and track_pyramids_plain (the
// tracker composed from it). The TPU kernel kept whole level images in VMEM
// and sampled windows with one-hot selector matmuls on the MXU; none of
// that is carried over.
//
// What bounds it on an H100: the function reads each level of both pyramids
// once (4.9 MB for 376x1241, about 1.5 us of HBM) and does ~2 kflop per
// iteration per keypoint (0.1 GFLOP a call at the main path's iteration
// counts, about 1.5 us at the f32 peak). The kernel is far from both: each
// keypoint is a serial chain of up to 30 iterations a level, each a gather,
// a warp reduction and a 2x2 solve, and keypoints pinned at a clamp or
// oscillating run all 30 at every level, so the latency of one iteration
// times the slowest keypoint's 90 sets the kernel's time.
//
// What the design does about it:
//  * one launch carries each keypoint from the coarsest level to level 0
//    (the only coupling between levels is uv * 2 and the running
//    eig > min_eig flag, kept in registers) and applies the tracker's gate
//    in the epilogue, so a call pays one launch and one tail instead of
//    three of each, and none of the ~50 small PyTorch ops around them;
//  * each warp copies (cp.async, no registers held) the 14x14 taps under
//    its 13x13 template and a PR x PC patch of img1 around its window into
//    shared memory in one round trip, computes the 169 bilinear template
//    samples once and takes T and the central-difference gradients from
//    them; the iterations sample from the patch and re-stage it only when
//    the window leaves it. The patch is small (320 floats) because staging
//    traffic for 2048 keypoints is what a larger one costs; its row stride
//    is 11 mod 32, so the 32 lanes' taps of an 11-wide window fall in 32
//    distinct banks;
//  * an iteration reduces (sum e, sum e gx, sum e gy) in one interleaved
//    butterfly, with sum (e - mean) g = sum e g - mean sum g and sum g from
//    the template, instead of two butterflies in series;
//  * the butterflies leave the same bits in every lane, so the early-exit
//    test is warp-uniform and a converged warp retires; dead slots write
//    their outputs and return at once.
// With one level and raw outputs the same kernel is the level solve
// (lk_cuda.track_level).

#include <cuda_runtime.h>

// The level table, passed by value (lk_cuda.level_descriptors builds it):
// both pyramids' level pointers, sizes and padded sizes, level 0 first.
// Outside the unnamed namespace so that the C entry point keeps external
// linkage.
constexpr int MAX_LEVELS = 4;
struct Levels {
  const float* img0[MAX_LEVELS];
  const float* img1[MAX_LEVELS];
  int H[MAX_LEVELS], W[MAX_LEVELS], Hp[MAX_LEVELS], Wp[MAX_LEVELS];
  int n;
};

namespace {

constexpr int HALF = 5;
constexpr int WIN = 2 * HALF + 1;          // 11
constexpr int NPIX = WIN * WIN;            // 121
constexpr int PPL = (NPIX + 31) / 32;      // window pixels per lane (4)
constexpr int TW = WIN + 2;                // template window (13)
constexpr int WARPS = 4;                   // keypoints per block
constexpr float LO = 6.0f;
// staged patch: PR rows x PC columns at row stride PS; a window's 12x12
// taps fit while its top-left lies within [0, PR - 12] x [0, PC - 12] of
// the patch origin
constexpr int PR = 16, PC = 20;
constexpr int PS = 43;                     // = 11 (mod 32)
constexpr int MR = (PR - WIN - 1) / 2;     // margins around a staged window
constexpr int MC = (PC - WIN - 1) / 2;
constexpr int B_OFF = (TW + 1) * PS;       // template samples after its taps

struct Params {
  float min_eig, max_residual, rel_residual, eps;
  int iters;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bilinear sample from four taps: rows blended first, then columns.
__device__ __forceinline__ float blend(float t00, float t10, float t01,
                                       float t11, float av, float au) {
  float rs0 = (1.f - av) * t00 + av * t10;
  float rs1 = (1.f - av) * t01 + av * t11;
  return (1.f - au) * rs0 + au * rs1;
}

struct Window {
  int r0, c0;
  float av, au;
};

// Top-left cell and fractions of a size x size window around (u, v),
// clamped so the +1 tap stays inside the padded Hp x Wp level.
__device__ __forceinline__ Window window_at(float u, float v, int size,
                                            int Hp, int Wp) {
  float fu = floorf(u), fv = floorf(v);
  int half = (size - 1) / 2;
  Window w;
  w.c0 = min(max((int)fu - half, 0), Wp - size - 1);
  w.r0 = min(max((int)fv - half, 0), Hp - size - 1);
  w.au = u - fu;
  w.av = v - fv;
  return w;
}

// floor(x) as a float and an int for 0 <= x < 2^22 with one add rounded
// down (the iterate is clamped to [LO, padded size - 8]): exactly floorf.
__device__ __forceinline__ int floor_pos(float x, float& fx) {
  const float magic = 12582912.f;          // 1.5 * 2^23
  float r = __fadd_rd(x, magic);
  fx = r - magic;
  return __float_as_int(r) - __float_as_int(magic);
}

// window_at for an iterate, which the clamps keep positive.
__device__ __forceinline__ Window window_pos(float u, float v, int Hp,
                                             int Wp) {
  float fu, fv;
  Window w;
  w.c0 = min(max(floor_pos(u, fu) - HALF, 0), Wp - WIN - 1);
  w.r0 = min(max(floor_pos(v, fv) - HALF, 0), Hp - WIN - 1);
  w.au = u - fu;
  w.av = v - fv;
  return w;
}

// Start copying rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of the
// zero-padded H x W image into `dst` at row stride PS, with cp.async (a tap
// past the image is zero-filled, as the padded level reads); r0, c0 >= 0
// by the window clamps. All of a warp's copies are in flight together.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_async(float* dst,
                                            const float* __restrict__ img,
                                            int H, int W, int r0, int c0,
                                            int lane) {
  static_assert(COLS <= 32, "one lane step advances at most one row");
  int r = lane / COLS, c = lane % COLS;
#pragma unroll 1
  for (int i = lane; i < ROWS * COLS; i += 32) {
    const bool in = r0 + r < H && c0 + c < W;
    const float* src = in ? img + (r0 + r) * W + c0 + c : img;
    unsigned d = (unsigned)__cvta_generic_to_shared(dst + r * PS + c);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
    r += 32 / COLS;
    c += 32 % COLS;
    if (c >= COLS) {
      c -= COLS;
      ++r;
    }
  }
}

// Wait for this lane's copies, then for the whole warp's.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ bool outside(const Window& w, int pr0, int pc0) {
  return w.r0 < pr0 || w.r0 > pr0 + PR - WIN - 1 || w.c0 < pc0
         || w.c0 > pc0 + PC - WIN - 1;
}

// Re-stage the patch around window w unless it already holds it
// (warp-uniform: w is the same in every lane).
__device__ __forceinline__ void cover(const Window& w, int& pr0, int& pc0,
                                      float* patch,
                                      const float* __restrict__ img, int H,
                                      int W, int lane) {
  if (outside(w, pr0, pc0)) {
    pr0 = max(w.r0 - MR, 0);
    pc0 = max(w.c0 - MC, 0);
    __syncwarp();
    stage_async<PR, PC>(patch, img, H, W, pr0, pc0, lane);
    staged();
  }
}

template <bool kTracker>
__global__ void __launch_bounds__(WARPS * 32)
lk_pyramid_kernel(Levels lv, Params prm, const float* __restrict__ uv0,
                  const float* __restrict__ seed,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ out_uv, float* __restrict__ out_a,
                  float* __restrict__ out_b, float* __restrict__ out_c,
                  unsigned char* __restrict__ out_status, int N) {
  __shared__ float s_tmpl[WARPS][B_OFF + TW * TW];
  __shared__ float s_patch[WARPS][PR * PS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * WARPS + warp;
  if (k >= N) return;
  float* tmpl = s_tmpl[warp];
  float* patch = s_patch[warp];

  // seed at the coarsest level; uv * 2 between levels (exact in f32)
  float ru = seed[2 * k] * (1.f / (1 << (lv.n - 1)));
  float rv = seed[2 * k + 1] * (1.f / (1 << (lv.n - 1)));
  const float u0 = uv0[2 * k], v0 = uv0[2 * k + 1];
  if (!valid[k]) {
    for (int l = lv.n - 1; l > 0; --l) {
      ru *= 2.f;
      rv *= 2.f;
    }
    if (lane == 0) {
      out_uv[2 * k] = ru;
      out_uv[2 * k + 1] = rv;
      if (kTracker) {
        out_a[k] = 1e9f;
        out_status[k] = 0;
      } else {
        out_a[k] = 0.f;
        out_b[k] = 1e9f;
        out_c[k] = 0.f;
      }
    }
    return;
  }

  // lane's window pixels as offsets into the patch and the template
  // samples (0 where unused)
  int off[PPL], toff[PPL];
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    int p = lane + 32 * j;
    int r = p < NPIX ? p / WIN : 0, c = p < NPIX ? p % WIN : 0;
    off[j] = r * PS + c;
    toff[j] = (r + 1) * TW + c + 1;   // inner 11x11 of the 13x13 samples
  }

  bool cond_all = true;
  float min_eig = 0.f, res = 0.f, t_std = 0.f;
  for (int l = lv.n - 1; l >= 0; --l) {
    const int H = lv.H[l], W = lv.W[l], Hp = lv.Hp[l], Wp = lv.Wp[l];
    const float s = 1.f / (1 << l);
    const float* img = lv.img1[l];
    const float hi_u = Wp - 8.f, hi_v = Hp - 8.f;
    ru = fminf(fmaxf(ru, LO), hi_u);
    rv = fminf(fmaxf(rv, LO), hi_v);
    Window w = window_pos(ru, rv, Hp, Wp);
    int pr0 = max(w.r0 - MR, 0), pc0 = max(w.c0 - MC, 0);

    // one round trip: the template's taps of img0 at uv0 / 2^l and the
    // patch of img1 around the seed's window
    const Window tw = window_at(u0 * s, v0 * s, TW, Hp, Wp);
    __syncwarp();   // the previous level's reads of both buffers are done
    stage_async<TW + 1, TW + 1>(tmpl, lv.img0[l], H, W, tw.r0, tw.c0, lane);
    stage_async<PR, PC>(patch, img, H, W, pr0, pc0, lane);
    staged();
    // the 169 bilinear template samples, once
    for (int q = lane; q < TW * TW; q += 32) {
      int o = (q / TW) * PS + q % TW;
      tmpl[B_OFF + q] = blend(tmpl[o], tmpl[o + PS], tmpl[o + 1],
                              tmpl[o + PS + 1], tw.av, tw.au);
    }
    __syncwarp();
    const float* B = tmpl + B_OFF;
    float T[PPL], gx[PPL], gy[PPL];
    float s_t = 0.f, s_tt = 0.f, s_xx = 0.f, s_xy = 0.f, s_yy = 0.f;
    float s_gx = 0.f, s_gy = 0.f;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      bool in = lane + 32 * j < NPIX;
      int o = toff[j];
      T[j] = in ? B[o] : 0.f;
      gx[j] = in ? 0.5f * (B[o + 1] - B[o - 1]) : 0.f;
      gy[j] = in ? 0.5f * (B[o + TW] - B[o - TW]) : 0.f;
      s_t += T[j];
      s_tt += T[j] * T[j];
      s_xx += gx[j] * gx[j];
      s_xy += gx[j] * gy[j];
      s_yy += gy[j] * gy[j];
      s_gx += gx[j];
      s_gy += gy[j];
    }
    s_gx = warp_sum(s_gx);
    s_gy = warp_sum(s_gy);
    const float t_mean = warp_sum(s_t) / 121.f;
    t_std = sqrtf(fmaxf(warp_sum(s_tt) / 121.f - t_mean * t_mean, 0.f));
    const float gxx = warp_sum(s_xx), gxy = warp_sum(s_xy),
                gyy = warp_sum(s_yy);
    const float det = gxx * gyy - gxy * gxy;
    const float trace = gxx + gyy;
    min_eig =
        (trace - sqrtf(fmaxf(trace * trace - 4.f * det, 0.f))) * 0.5f / 121.f;
    const float det_safe = fabsf(det) < 1e-6f ? 1e-6f : det;
    const float iG00 = gyy / det_safe, iG01 = -gxy / det_safe,
                iG11 = gxx / det_safe;

    // iterations on img1, sampled from the staged patch
    float step = 1e9f;
    for (int it = 0; it < prm.iters && step >= prm.eps; ++it) {
      if (it > 0) w = window_pos(ru, rv, Hp, Wp);
      cover(w, pr0, pc0, patch, img, H, W, lane);
      const float* P = patch + (w.r0 - pr0) * PS + (w.c0 - pc0);
      float err[PPL];
      float s_e = 0.f, s_bx = 0.f, s_by = 0.f;
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const float* t = P + off[j];
        err[j] = lane + 32 * j < NPIX
                     ? blend(t[0], t[PS], t[1], t[PS + 1], w.av, w.au) - T[j]
                     : 0.f;
        s_e += err[j];
        s_bx += err[j] * gx[j];
        s_by += err[j] * gy[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s_e += __shfl_xor_sync(0xffffffffu, s_e, o);
        s_bx += __shfl_xor_sync(0xffffffffu, s_bx, o);
        s_by += __shfl_xor_sync(0xffffffffu, s_by, o);
      }
      // sum (e - mean) g = sum e g - mean * sum g
      const float e_mean = s_e / 121.f;
      const float bx = s_bx - e_mean * s_gx;
      const float by = s_by - e_mean * s_gy;
      const float du = -(iG00 * bx + iG01 * by);
      const float dv = -(iG01 * bx + iG11 * by);
      step = sqrtf(du * du + dv * dv);
      ru = fminf(fmaxf(ru + du, LO), hi_u);
      rv = fminf(fmaxf(rv + dv, LO), hi_v);
    }

    // residual at the solution
    w = window_pos(ru, rv, Hp, Wp);
    cover(w, pr0, pc0, patch, img, H, W, lane);
    const float* P = patch + (w.r0 - pr0) * PS + (w.c0 - pc0);
    float s_r = 0.f;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const float* t = P + off[j];
      if (lane + 32 * j < NPIX)
        s_r += fabsf(blend(t[0], t[PS], t[1], t[PS + 1], w.av, w.au) - T[j]);
    }
    res = warp_sum(s_r) / 121.f;
    cond_all = cond_all && min_eig > prm.min_eig;
    if (l > 0) {
      ru *= 2.f;
      rv *= 2.f;
    }
  }

  if (lane == 0) {
    out_uv[2 * k] = ru;
    out_uv[2 * k + 1] = rv;
    if (kTracker) {
      // status: well conditioned at every level, inside the unpadded
      // level 0 by HALF, residual under max(max_residual, rel * std(T))
      const float W0 = lv.W[0], H0 = lv.H[0];
      const bool in_bounds = ru >= HALF && ru < W0 - HALF && rv >= HALF
                             && rv < H0 - HALF;
      const float gate = fmaxf(prm.rel_residual * t_std, prm.max_residual);
      out_a[k] = res;
      out_status[k] = cond_all && in_bounds && res < gate;
    } else {
      out_a[k] = min_eig;
      out_b[k] = res;
      out_c[k] = t_std;
    }
  }
}

}  // namespace

// mode 1: the tracker over lv.n levels; outputs uv, residual (out_a) and
// status. mode 0: one level (lv.n == 1); outputs uv, min_eig (out_a),
// residual (out_b) and std(T) (out_c).
extern "C" int yavo_lk_level(Levels lv, const float* uv0, const float* seed,
                             const unsigned char* valid, float* out_uv,
                             float* out_a, float* out_b, float* out_c,
                             unsigned char* out_status, int N, int iters,
                             float eps, float min_eig, float max_residual,
                             float rel_residual, int mode, void* stream) {
  if (lv.n < 1 || lv.n > MAX_LEVELS || (mode == 0 && lv.n != 1))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  Params prm{min_eig, max_residual, rel_residual, eps, iters};
  const int blocks = (N + WARPS - 1) / WARPS;
  if (mode == 1)
    lk_pyramid_kernel<true><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        lv, prm, uv0, seed, valid, out_uv, out_a, out_b, out_c, out_status,
        N);
  else
    lk_pyramid_kernel<false><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        lv, prm, uv0, seed, valid, out_uv, out_a, out_b, out_c, out_status,
        N);
  return (int)cudaGetLastError();
}
