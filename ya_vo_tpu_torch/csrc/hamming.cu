// Hamming distance matrix between packed binary descriptors, on the int8
// tensor cores.
//
// Replaces the TPU kernel ya_vo_tpu/features/pallas_hamming.py:_hamming_kernel
// (launched by hamming_matrix_pallas), which unpacks bits to +-1 and runs an
// MXU matmul per 256x256 tile. Here the bits are unpacked to 0/1 bytes in
// registers, straight into the fragments of `mma.sync` m16n8k32 u8 x u8 ->
// s32, and each distance is popc(a) + popc(b) - 2 <a, b>: exact integers.
//
// What bounds it on an H100: at 2048 x 2048 descriptors of 256 bits the
// function writes a 16.8 MB int32 matrix (about 5 us of HBM) and needs
// 2.1 G int8 operations (about 1.1 us of tensor-core peak); the write bounds
// it. A popc(a ^ b) kernel issues 33.5M XOR+POPC pairs on the integer pipes
// (~8 us of issue at ~16 popc per SM per clock), so the product goes to the
// tensor cores. The unpacking costs a shift and a mask per fragment
// register: the k order inside each 32-bit word is permuted (fragment byte
// i of lane group t holds bit t + 8i, or t + 4 + 8i for the upper half) the
// same way for both operands, which leaves the dot product unchanged.
// Each warp computes a 32 x 64 tile: it unpacks its 32 rows' fragments for
// every k step once, then runs one 8-column slice at a time and writes the
// slice as soon as it is summed, so the stores stream out while the other
// slices compute (the write is the bound). The epilogue swaps half of each
// lane pair's accumulators so every lane holds four adjacent columns of one
// row and writes them with one 16-byte store.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_WORDS = 16;
constexpr int WM = 32, WN = 64;            // warp tile
constexpr int BM = 2 * WM, BN = 2 * WN;    // block tile, 2 x 2 warps
constexpr int THREADS = 128;
constexpr int OUT_STRIDE = 40;             // parked row: 32 ints + 8 pad

__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KW: descriptor words the kernel reads per row (8 or 16); a shorter
// descriptor is padded with zero words, which add nothing to the popcounts
// or the dot product.
template <int KW>
__global__ void __launch_bounds__(THREADS)
hamming_kernel(const unsigned* __restrict__ d1,
               const unsigned* __restrict__ d2, int* __restrict__ out, int K1,
               int K2, int n_words) {
  constexpr int STRIDE = KW + 1;           // staged words per row (padded)
  __shared__ unsigned s1[BM * STRIDE];
  __shared__ unsigned s2[BN * STRIDE];
  __shared__ int pop1[BM], pop2[BN];
  __shared__ __align__(16) int s_out[THREADS / 32][WM * OUT_STRIDE];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // one row per thread: stage its words and count its bits
  for (int r = threadIdx.x; r < BM + BN; r += THREADS) {
    const bool is1 = r < BM;
    const int g_row = is1 ? row0 + r : col0 + r - BM;
    const bool in = g_row < (is1 ? K1 : K2);
    const unsigned* src = (is1 ? d1 : d2) + (long long)g_row * n_words;
    unsigned* dst = is1 ? s1 + r * STRIDE : s2 + (r - BM) * STRIDE;
    int p = 0;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      unsigned v = in && w < n_words ? __ldg(src + w) : 0u;
      dst[w] = v;
      p += __popc(v);
    }
    if (is1) pop1[r] = p; else pop2[r - BM] = p;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * WM, wc = (warp & 1) * WN;
  // A fragments of the warp's 32 rows for every k step
  unsigned a[KW][2][4];
#pragma unroll
  for (int w = 0; w < KW; ++w)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned lo = s1[(wr + mt * 16 + g) * STRIDE + w];
      unsigned hi = s1[(wr + mt * 16 + g + 8) * STRIDE + w];
      a[w][mt][0] = (lo >> t) & 0x01010101u;
      a[w][mt][1] = (hi >> t) & 0x01010101u;
      a[w][mt][2] = (lo >> (t + 4)) & 0x01010101u;
      a[w][mt][3] = (hi >> (t + 4)) & 0x01010101u;
    }

  // 32-column groups: the warp sums four 8-column slices, parks them in
  // shared memory and writes each of its 32 rows as one full 128-byte line
  // (eight lanes a row, 16 bytes a lane)
  int* park = s_out[warp];
  const bool vec = (K2 & 3) == 0;
#pragma unroll 1
  for (int cg = 0; cg < WN / 32; ++cg) {
    int acc[2][4][4] = {};
#pragma unroll
    for (int w = 0; w < KW; ++w)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        unsigned wb = s2[(wc + cg * 32 + nt * 8 + g) * STRIDE + w];
        unsigned b0 = (wb >> t) & 0x01010101u;
        unsigned b1 = (wb >> (t + 4)) & 0x01010101u;
        mma_u8(acc[0][nt], a[w][0], b0, b1);
        mma_u8(acc[1][nt], a[w][1], b0, b1);
      }
    __syncwarp();   // the previous group's rows have been read
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = nt * 8 + 2 * t;
        const int* pb = pop2 + wc + cg * 32 + c;
        const int* pa = pop1 + wr + mt * 16 + g;
        const int pa0 = pa[0], pa1 = pa[8], pb0 = pb[0], pb1 = pb[1];
        int2 lo = make_int2(pa0 + pb0 - 2 * acc[mt][nt][0],
                            pa0 + pb1 - 2 * acc[mt][nt][1]);
        int2 hi = make_int2(pa1 + pb0 - 2 * acc[mt][nt][2],
                            pa1 + pb1 - 2 * acc[mt][nt][3]);
        *reinterpret_cast<int2*>(park + (mt * 16 + g) * OUT_STRIDE + c) = lo;
        *reinterpret_cast<int2*>(park + (mt * 16 + g + 8) * OUT_STRIDE + c) =
            hi;
      }
    __syncwarp();
    const int col = col0 + wc + cg * 32 + (lane & 7) * 4;
#pragma unroll
    for (int i = 0; i < WM / 4; ++i) {
      const int rl = i * 4 + (lane >> 3);
      const int r = row0 + wr + rl;
      const int4 v = *reinterpret_cast<const int4*>(park + rl * OUT_STRIDE
                                                    + (lane & 7) * 4);
      if (r >= K1) continue;
      int* dst = out + (long long)r * K2 + col;
      if (vec && col + 3 < K2) {
        *reinterpret_cast<int4*>(dst) = v;
      } else {
        if (col < K2) dst[0] = v.x;
        if (col + 1 < K2) dst[1] = v.y;
        if (col + 2 < K2) dst[2] = v.z;
        if (col + 3 < K2) dst[3] = v.w;
      }
    }
  }
}

}  // namespace

extern "C" int yavo_hamming(const void* d1, const void* d2, int* out, int K1,
                            int K2, int n_words, void* stream) {
  if (n_words < 1 || n_words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  if (K1 <= 0 || K2 <= 0) return 0;
  dim3 grid((K2 + BN - 1) / BN, (K1 + BM - 1) / BM);
  if (n_words <= 8)
    hamming_kernel<8><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned*)d1, (const unsigned*)d2, out, K1, K2, n_words);
  else
    hamming_kernel<16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned*)d1, (const unsigned*)d2, out, K1, K2, n_words);
  return (int)cudaGetLastError();
}
