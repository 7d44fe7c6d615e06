// Top-K selection of the FAST candidates, straight into keypoint slots.
//
// Replaces `jax.lax.top_k` at ya_vo_tpu/features/fast.py:193 (XLA, not a
// Pallas kernel) and, in the port, the stable sort of every pixel's score
// that `detect` ran before. Same outputs as the plain PyTorch version
// ya_vo_tpu_torch/features/fast_cuda.py:select_top_k_plain: slot p holds the
// candidate of rank p in the order score descending, ties by the lower flat
// index; slots past the count hold score 0, mask false and the lowest flat
// indices that are not candidates, in ascending order.
//
// Each candidate gets a unique 64-bit key: the score's bits mapped so that
// unsigned order is float order (-0 taken as +0, as the sort compares), then
// the inverted index. A candidate's rank is the number of keys above its
// own, so every candidate finds its slot alone and no two collide: there is
// no merge and no pass across blocks, and the count is read on the card, so
// the caller never waits for it.
//
// What bounds it on an H100: the bytes (8 a candidate in, 13 a slot out)
// are tens of KB, 0.000015 ms of HBM time. The rank counting is n^2
// compares of 8-byte keys read from shared memory: at the main path's ~3k
// candidates that is ~9M compares and ~70 MB of shared-memory reads spread
// over every SM, and this shared-memory traffic is the time. Up to CHUNK
// candidates (the main path's case), each block stages all keys in shared
// memory once, and each warp ranks at most one or two candidates, its lanes
// splitting the keys. Past CHUNK, each thread ranks four candidates while
// the block streams the keys through shared memory in chunks: correct at
// any count up to H*W, and slow (the pathological case, an image whose NMS
// plateaus keep most pixels). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): 0.0060 ms a call on 2,954 candidates, where one
// `torch.topk` over the same keys takes 0.048 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;       // 32: one warp scans their sums
constexpr int CHUNK = 8192;               // keys staged in shared memory
constexpr int SMEM = CHUNK * 8;           // 64 KB, dynamic
constexpr int CPT = 4;                    // candidates a thread, past CHUNK

__device__ __forceinline__ unsigned long long make_key(float s, int idx) {
  s = s + 0.0f;                           // -0 -> +0
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(~idx);
}

__device__ __forceinline__ void write_slot(int slot, int idx, float score,
                                           bool valid, int W, float* uv,
                                           float* out_score,
                                           uint8_t* out_mask) {
  uv[2 * slot] = (float)(idx % W);
  uv[2 * slot + 1] = (float)(idx / W);
  out_score[slot] = score;
  out_mask[slot] = valid;
}

// Exclusive prefix sum of v over the block's threads, in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    s_warp[lane] = wi - w;
  }
  __syncthreads();
  return s_warp[warp] + inc - v;
}

__global__ void __launch_bounds__(THREADS)
fast_select_kernel(const float* __restrict__ score,
                   const int* __restrict__ idx, const int* __restrict__ count,
                   int K, int W, float* __restrict__ uv,
                   float* __restrict__ out_score,
                   uint8_t* __restrict__ out_mask) {
  extern __shared__ unsigned long long s_key[];
  __shared__ unsigned s_taken[CHUNK / 32];  // candidate indices below K
  __shared__ int s_warp[WARPS];

  const int tid = threadIdx.x, lane = tid & 31;
  const int n = *count;

  if (n <= CHUNK) {
    for (int i0 = 0; i0 < n; i0 += 4 * THREADS) {  // 4 loads in flight
      float sc[4];
      int id[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS + tid;
        if (i < n) {
          sc[u] = score[i];
          id[u] = idx[i];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS + tid;
        if (i < n) s_key[i] = make_key(sc[u], id[u]);
      }
    }
    __syncthreads();
    const int n_warps = gridDim.x * WARPS;
    for (int c = blockIdx.x * WARPS + tid / 32; c < n; c += n_warps) {
      const unsigned long long key = s_key[c];
      int rank = 0;
      for (int j = lane; j < n; j += 32) rank += s_key[j] > key;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rank += __shfl_xor_sync(0xffffffffu, rank, o);
      if (lane == 0 && rank < K)
        write_slot(rank, idx[c], score[c], true, W, uv, out_score, out_mask);
    }
  } else {
    const int per_pass = gridDim.x * THREADS * CPT;
    const int passes = (n + per_pass - 1) / per_pass;
    for (int p = 0; p < passes; ++p) {
      int c[CPT], rank[CPT];
      unsigned long long key[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        c[q] = p * per_pass + (q * gridDim.x + blockIdx.x) * THREADS + tid;
        key[q] = c[q] < n ? make_key(score[c[q]], idx[c[q]]) : 0ull;
        rank[q] = 0;
      }
      for (int j0 = 0; j0 < n; j0 += CHUNK) {
        const int m = min(CHUNK, n - j0);
        __syncthreads();
        for (int i = tid; i < m; i += THREADS)
          s_key[i] = make_key(score[j0 + i], idx[j0 + i]);
        __syncthreads();
        for (int j = 0; j < m; ++j) {
          const unsigned long long k = s_key[j];
#pragma unroll
          for (int q = 0; q < CPT; ++q) rank[q] += k > key[q];
        }
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q)
        if (c[q] < n && rank[q] < K)
          write_slot(rank[q], idx[c[q]], score[c[q]], true, W, uv, out_score,
                     out_mask);
    }
  }

  // slots n..K-1 (n < K <= CHUNK): the lowest flat indices that are not
  // candidates; all of them lie below K, so a K-bit map of the candidates
  // there and a prefix count over it give each one its slot
  if (blockIdx.x != 0 || n >= K) return;
  const int words = (K + 31) / 32;
  for (int i = tid; i < words; i += THREADS) s_taken[i] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    const int id = idx[i];
    if (id < K) atomicOr(&s_taken[id / 32], 1u << (id % 32));
  }
  __syncthreads();
  const int seg = (K + THREADS - 1) / THREADS;
  const int lo = min(K, tid * seg), hi = min(K, lo + seg);
  int free = 0;
  for (int x = lo; x < hi; ++x) free += !((s_taken[x / 32] >> (x % 32)) & 1u);
  int slot = n + block_exclusive_scan(free, s_warp);
  for (int x = lo; x < hi && slot < K; ++x)
    if (!((s_taken[x / 32] >> (x % 32)) & 1u))
      write_slot(slot++, x, 0.0f, false, W, uv, out_score, out_mask);
}

}  // namespace

extern "C" int yavo_fast_select(const float* score, const int* idx,
                                const int* count, int K, int W, float* uv,
                                float* out_score, uint8_t* out_mask,
                                void* stream) {
  static int n_blocks = 0;
  if (n_blocks == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fast_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    n_blocks = sms;
  }
  if (K < 1 || K > CHUNK) return (int)cudaErrorInvalidValue;
  fast_select_kernel<<<n_blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      score, idx, count, K, W, uv, out_score, out_mask);
  return (int)cudaGetLastError();
}
