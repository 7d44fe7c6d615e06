// FAST-12 segment test + Harris response + NMS, compacted into candidates.
//
// Replaces the TPU kernel ya_vo_tpu/features/pallas_fast.py:_fast_score_kernel
// (launched by fast_score_map). Same function as the plain PyTorch version
// ya_vo_tpu_torch/features/fast_cuda.py:fast_candidates_plain: every stage
// reads zeros outside the image; a pixel is a candidate where it passes the
// segment test, its Harris score is the maximum of its (2r+1)^2 window, and
// it lies `border` px or more inside the image. Each candidate is written as
// (score, flat index) in no particular order, and `count` holds how many;
// at border 0 the candidates scattered into a NEG map are the score map.
//
// What bounds it on an H100: not bytes. The uint8 frame in (466 KB at
// 376x1241) and ~3k candidates out take 0.00015 ms of HBM time, and the
// operations this frame needs 0.00028 ms. Only ~14% of pixels pass the
// cardinal pre-test and ~4% are corners needing Harris and NMS. The time is
// each block's chain of dependent passes (stage, pre-test, ring test,
// Harris, NMS, write), bound by instruction issue and shared-memory latency.
// The kernel takes as long as its slowest block, a textured tile whose ring
// test has the most passes to run. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py): 0.0099-0.0100 ms a call, against 0.0247 ms for
// the earlier one-pass design that computed every stage at every pixel.
// The design does only the work each pixel needs, on dense work lists
// instead of divergent branches:
//   1. a 32x64 output tile and its halo are staged as uint8 from aligned
//      32-bit words (W need not be a multiple of 4), zero outside the image;
//   2. every pixel of the tile and its NMS margin runs the 4-tap cardinal
//      pre-test (a run of n ring positions holds at least n/4 cardinals, so
//      the test is exact); the passes are compacted in order by ballots and
//      one scan, with no atomics on the way;
//   3. the full 16-tap ring test runs on that list and compacts the corners;
//   4. Harris runs only at those corners, from their 5x5 neighbourhood in
//      integer arithmetic (Sobel sums and products are exact integers below
//      2^24, equal to the plain version's float sums), products of
//      neighbours outside the image counted as 0;
//   5. NMS, with the radius a template parameter, runs only at the tile's
//      corners, and the ones inside the border are compacted and written
//      after one atomicAdd a block on the global count.
// 512 threads a block: more warps to hide each pass's latency. Built with
// -fmad=false so det - k*trace^2 rounds as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;                  // output rows per block
constexpr int TW = 64;                  // output cols per block
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -3.0e38f;

__constant__ int RING_DV[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int RING_DU[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

// >= n contiguous set bits in the cyclic 16-bit field (log-doubling AND).
// The field is doubled into 32 bits, so each rotation of the plain version
// is a plain shift: bit i of the low half still sees bits i..i+n-1 mod 16.
__device__ __forceinline__ bool has_run(int b, int n) {
  unsigned r = (unsigned)b | ((unsigned)b << 16);
  int covered = 1;
  while (covered < n) {
    const int s = min(covered, n - covered);
    r &= r >> s;
    covered += s;
  }
  return (r & 0xFFFFu) != 0;
}

// Appends `item` to list[*n] where `pred` holds, one shared atomic a warp.
// Every lane of the warp must call it.
__device__ __forceinline__ void push(bool pred, uint16_t item, uint16_t* list,
                                     int* n) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (pred) list[base + __popc(m & ((1u << lane) - 1))] = item;
}

template <int R>
__global__ void __launch_bounds__(THREADS)
fast_score_kernel(const uint8_t* __restrict__ img,
                  float* __restrict__ cand_score, int* __restrict__ cand_idx,
                  int* __restrict__ count, int H, int W, float threshold,
                  int arc_length, float harris_k, int border) {
  constexpr int CH = TH + 2 * R, CW = TW + 2 * R;  // scores the NMS reads
  constexpr int HALO = R + 3;                      // + ring radius
  constexpr int SH = TH + 2 * HALO, SW = TW + 2 * HALO;
  constexpr int SWP = (SW + 3) & ~3;
  constexpr int NWORDS = SW / 4 + 2;               // words covering a row

  __shared__ uint8_t s_img[SH][SWP];
  __shared__ float s_score[CH][CW];
  __shared__ uint16_t s_a[CH * CW];   // pre-test passes, then kept corners
  __shared__ uint16_t s_b[CH * CW];   // corners of the region
  __shared__ uint16_t s_c[TH * TW];   // corners of the output tile
  __shared__ int s_n[4];
  __shared__ int s_base;

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int ys = y0 - HALO, xs = x0 - HALO;
  const long long npix = (long long)H * W;

  if (tid < 4) s_n[tid] = 0;
  for (int i = tid; i < CH * CW; i += THREADS) (&s_score[0][0])[i] = NEG;

  // 1. stage the tile and its halo from aligned words, zero outside
  for (int i = tid; i < SH * NWORDS; i += THREADS) {
    const int r = i / NWORDS, k = i - r * NWORDS;
    const int y = ys + r;
    const long long f0 = (long long)y * W + xs;    // flat index of col 0
    const long long w = (f0 >> 2) + k;             // aligned word
    if (4 * w > f0 + SW - 1) continue;
    uint32_t word = 0;
    if (y >= 0 && y < H) {
      if (4 * w >= 0 && 4 * w + 3 < npix) {
        word = __ldg(reinterpret_cast<const uint32_t*>(img) + w);
      } else {
        for (int j = 0; j < 4; ++j)
          if (4 * w + j >= 0 && 4 * w + j < npix)
            word |= (uint32_t)img[4 * w + j] << (8 * j);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (int)(4 * w + j - f0);
      const int x = xs + c;
      if (c >= 0 && c < SW)
        s_img[r][c] = (x >= 0 && x < W) ? (uint8_t)(word >> (8 * j)) : 0;
    }
  }
  __syncthreads();

  // the segment test's compares, exact in integers: v > c + t  <=>
  // v > floor(c + t), and v < c - t  <=>  v < ceil(c - t), for integer v
  auto bounds = [&](int center, int& hi, int& lo) {
    const float fc = (float)center;
    hi = (int)floorf(fminf(fmaxf(fc + threshold, -1.f), 256.f));
    lo = (int)ceilf(fminf(fmaxf(fc - threshold, -1.f), 256.f));
  };

  // 2. cardinal pre-test over the tile and its NMS margin; the passes are
  // compacted in index order by one ballot an item and a scan of the
  // (item, warp) counts, with no atomics on the way
  constexpr int N2 = CH * CW;
  constexpr int PER = (N2 + THREADS - 1) / THREADS;  // items a thread
  constexpr int NC = PER * WARPS;
  constexpr int EPL = (NC + 31) / 32;                // counts a lane scans
  __shared__ int s_off[NC];
  const int warp = tid >> 5, lane = tid & 31;
  const int quarter = arc_length / 4;
  unsigned ballot[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = q * THREADS + tid;
    bool pass = false;
    if (i < N2) {
      const int rr = i / CW, cc = i - rr * CW;
      const int y = y0 - R + rr, x = x0 - R + cc;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const int sr = rr + 3, sc = cc + 3;
        int hi, lo;
        bounds(s_img[sr][sc], hi, lo);
        const int a = s_img[sr - 3][sc], b = s_img[sr][sc + 3],
                  c = s_img[sr + 3][sc], d = s_img[sr][sc - 3];
        const int nb = (a > hi) + (b > hi) + (c > hi) + (d > hi);
        const int nd = (a < lo) + (b < lo) + (c < lo) + (d < lo);
        pass = nb >= quarter || nd >= quarter;
      }
    }
    ballot[q] = __ballot_sync(0xffffffffu, pass);
    if (lane == 0) s_off[q * WARPS + warp] = __popc(ballot[q]);
  }
  __syncthreads();
  if (warp == 0) {                       // exclusive scan of the counts
    int v[EPL], sum = 0;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int k = lane * EPL + e;
      v[e] = k < NC ? s_off[k] : 0;
      sum += v[e];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    int run = inc - sum;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int k = lane * EPL + e;
      if (k < NC) s_off[k] = run;
      run += v[e];
    }
    if (lane == 31) s_n[0] = inc;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if ((ballot[q] >> lane) & 1u)
      s_a[s_off[q * WARPS + warp] + __popc(ballot[q] & below)] =
          (uint16_t)(q * THREADS + tid);
  __syncthreads();

  // 3. the full ring test on the passes
  const int n_a = s_n[0];
  for (int i0 = 0; i0 < n_a; i0 += THREADS) {
    const int j = i0 + tid;
    bool corner = false;
    uint16_t i = 0;
    if (j < n_a) {
      i = s_a[j];
      const int rr = i / CW, cc = i - rr * CW;
      const int sr = rr + 3, sc = cc + 3;
      int hi, lo;
      bounds(s_img[sr][sc], hi, lo);
      int bright = 0, dark = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int v = s_img[sr + RING_DV[k]][sc + RING_DU[k]];
        bright |= (v > hi) << k;
        dark |= (v < lo) << k;
      }
      corner = has_run(bright, arc_length) || has_run(dark, arc_length);
    }
    push(corner, i, s_b, &s_n[1]);
  }
  __syncthreads();

  // 4. Harris at the corners; the tile's corners go on to NMS
  const int n_b = s_n[1];
  for (int i0 = 0; i0 < n_b; i0 += THREADS) {
    const int j = i0 + tid;
    bool in_tile = false;
    uint16_t t = 0;
    if (j < n_b) {
      const int i = s_b[j];
      const int rr = i / CW, cc = i - rr * CW;
      const int y = y0 - R + rr, x = x0 - R + cc;
      const int sr = rr + 3, sc = cc + 3;
      int v[5][5];
#pragma unroll
      for (int a = 0; a < 5; ++a)
#pragma unroll
        for (int b = 0; b < 5; ++b) v[a][b] = s_img[sr - 2 + a][sc - 2 + b];
      int sxx = 0, syy = 0, sxy = 0;
#pragma unroll
      for (int dv = 0; dv < 3; ++dv) {
#pragma unroll
        for (int du = 0; du < 3; ++du) {
          const int py = y - 1 + dv, px = x - 1 + du;
          if (py < 0 || py >= H || px < 0 || px >= W) continue;
          // Sobel at (dv + 1, du + 1) of the 5x5 neighbourhood
          const int gx = (v[dv][du + 2] + 2 * v[dv + 1][du + 2] + v[dv + 2][du + 2])
                       - (v[dv][du] + 2 * v[dv + 1][du] + v[dv + 2][du]);
          const int gy = (v[dv + 2][du] + 2 * v[dv + 2][du + 1] + v[dv + 2][du + 2])
                       - (v[dv][du] + 2 * v[dv][du + 1] + v[dv][du + 2]);
          sxx += gx * gx;
          syy += gy * gy;
          sxy += gx * gy;
        }
      }
      const float bxx = (float)sxx, byy = (float)syy, bxy = (float)sxy;
      const float det = bxx * byy - bxy * bxy;
      const float trace = bxx + byy;
      s_score[rr][cc] = det - harris_k * trace * trace;
      in_tile = rr >= R && rr < R + TH && cc >= R && cc < R + TW;
      t = (uint16_t)((rr - R) * TW + (cc - R));
    }
    push(in_tile, t, s_c, &s_n[2]);
  }
  __syncthreads();

  // 5. NMS at the tile's corners (ties on a plateau all survive), border
  const int n_c = s_n[2];
  for (int i0 = 0; i0 < n_c; i0 += THREADS) {
    const int j = i0 + tid;
    bool keep = false;
    uint16_t t = 0;
    if (j < n_c) {
      t = s_c[j];
      const int r = t / TW, c = t - r * TW;
      const int y = y0 + r, x = x0 + c;
      const float s = s_score[r + R][c + R];
      float m = s;
#pragma unroll
      for (int dv = 0; dv <= 2 * R; ++dv)
#pragma unroll
        for (int du = 0; du <= 2 * R; ++du) m = fmaxf(m, s_score[r + dv][c + du]);
      keep = s >= m && y >= border && y < H - border && x >= border &&
             x < W - border;
    }
    push(keep, t, s_a, &s_n[3]);
  }
  __syncthreads();

  // 6. one global atomic a block, then the block's candidates
  const int n_k = s_n[3];
  if (tid == 0) s_base = n_k ? atomicAdd(count, n_k) : 0;
  __syncthreads();
  for (int j = tid; j < n_k; j += THREADS) {
    const int t = s_a[j];
    const int r = t / TW, c = t - r * TW;
    cand_score[s_base + j] = s_score[r + R][c + R];
    cand_idx[s_base + j] = (y0 + r) * W + (x0 + c);
  }
}

}  // namespace

extern "C" int yavo_fast_score(const uint8_t* img, float* cand_score,
                               int* cand_idx, int* count, int H, int W,
                               float threshold, int arc_length,
                               float harris_k, int nms_radius, int border,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
#define YAVO_FAST_LAUNCH(R)                                                   \
  fast_score_kernel<R><<<grid, THREADS, 0, st>>>(                             \
      img, cand_score, cand_idx, count, H, W, threshold, arc_length,          \
      harris_k, border)
  switch (nms_radius) {
    case 0: YAVO_FAST_LAUNCH(0); break;
    case 1: YAVO_FAST_LAUNCH(1); break;
    case 2: YAVO_FAST_LAUNCH(2); break;
    case 3: YAVO_FAST_LAUNCH(3); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef YAVO_FAST_LAUNCH
  return (int)cudaGetLastError();
}
