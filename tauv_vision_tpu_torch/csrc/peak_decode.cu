// Heatmap peak decode: sigmoid -> kxk max-pool-equality NMS -> flat top-K.
//
// Replaces tauv_vision_tpu/ops/pallas/peak_decode.py:peak_decode_pallas
// (kernel _peak_decode_kernel), the drop-in twin of ops/peaks.peak_decode.
//
// What bounds it on Hopper: not bytes (the main-path map is [B, 4, 90,
// 160] f32, 1.84 MB at batch 8, 0.6 us at 3.35 TB/s) but latency: how
// many SMs the work spreads over and how many dependent steps each takes.
// Two launches, and the suppressed map never reaches device memory:
//   1. tile_topk_kernel, one block per (image, channel, tile of tile_h
//      rows x tile_w columns): 24 blocks an image on the main path (6
//      bands of 16 rows at full width, 4 channels).  The block stages the
//      tile and a halo of pad cells as probabilities in shared memory
//      (one expf a cell, the halo's few recomputed by the neighbour),
//      applies the NMS from there, compacts the cells that survive with a
//      probability > 0 as 64-bit keys (float bits << 32 | ~flat index),
//      bitonic-sorts them (a power of two >= their count) and writes its
//      best K keys, 0 past its count, to a [B, tiles, K] buffer.
//   2. merge_kernel, one block per image: the running best K beside a
//      chunk of the image's candidate keys, sorted, chunk after chunk;
//      then the K results.  Where fewer than K cells are positive, the
//      remaining slots are the zero-valued cells of smallest flat index.
// The merge is exact.  The key order is the top-k order (score
// descending, then flat index ascending: jax.lax.top_k's tie rule), a
// total order, so the image's best K keys are among the union of every
// tile's best K.  Probabilities are >= 0, so their f32 bits order as
// unsigned integers.  Every cell not positive has the value 0 (it was
// suppressed, or its sigmoid underflowed), and zeros tie: they are
// ordered by flat index alone.  If the image has fewer than K positive
// cells, every tile reported all of its own, so the merge knows the
// whole positive set and can name the zeros of smallest index.
// The NMS compares probabilities, not logits: sigmoid maps distinct large
// logits to the same f32 1.0, and those must tie as they do in the
// reference.  The sigmoid is 1/(1+expf(-x)) (no fast math), the formula
// PyTorch's own CUDA sigmoid uses.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 4096;      // tile_h * tile_w; keys of a tile: 32 KB
constexpr int kMergeKeys = 4096;    // keys a merge step sorts: 32 KB
constexpr int kMaxK = 128;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ unsigned long long make_key(float v, int flat) {
  return ((unsigned long long)__float_as_uint(v) << 32) |
         (unsigned int)(~flat);
}

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sorts keys[0, n) descending; n a power of two; all threads of the block.
// Pair t of a step compares i = (t with a 0 inserted at bit log2(j)) and
// i + j.  While j <= 32 a warp's pairs stay inside the same 64-key runs
// (keys 64 q to 64 q + 63 for its pairs 32 q to 32 q + 31) from step to
// step, so those steps need only the warp's own barrier; a step with j
// >= 64, the step before one, and the last step take the block's.
__device__ void bitonic_sort_desc(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const unsigned long long a = keys[i];
        const unsigned long long b = keys[l];
        const bool desc = (i & k) == 0;
        if (desc ? a < b : a > b) {
          keys[i] = b;
          keys[l] = a;
        }
      }
      if (j >= 64 || (j == 1 && (k >= 64 || k == n)))
        __syncthreads();
      else
        __syncwarp();
    }
  }
}

// Dynamic shared memory: next_pow2(tile_h * tile_w) keys, then the staged
// probabilities [tile_h + 2 pad][tile_w + 2 pad] (-1 outside the map).
// kPad >= 0 fixes the window at compile time (1: the served 3x3); -1
// reads it from pad_arg.
template <int kPad>
__global__ void __launch_bounds__(kThreads)
tile_topk_kernel(const float* __restrict__ logits,
                 unsigned long long* __restrict__ cand, int C, int H, int W,
                 int K, int pad_arg, int tile_h, int tile_w, int tiles_y,
                 int tiles_x) {
  const int pad = kPad >= 0 ? kPad : pad_arg;
  extern __shared__ unsigned long long smem_keys[];
  __shared__ int s_count;
  const int tile_elems = tile_h * tile_w;
  float* stage = (float*)(smem_keys + next_pow2(tile_elems));
  const int sw = tile_w + 2 * pad;
  const int sh = tile_h + 2 * pad;

  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int c = t / tiles_y;
  const int b = blockIdx.y;
  const int y0 = ty * tile_h;
  const int x0 = tx * tile_w;
  const float* plane = logits + ((long long)b * C + c) * H * W;

  if (threadIdx.x == 0) s_count = 0;
  // Element i = threadIdx.x + kThreads * step of a row-major [rows][cols]
  // array sits at (r, q); each step moves it by (kThreads / cols,
  // kThreads % cols), so the loops divide once, not once an element.
  {
    int r = threadIdx.x / sw, q = threadIdx.x % sw;
    const int dr = kThreads / sw, dq = kThreads % sw;
#pragma unroll 4
    for (int i = threadIdx.x; i < sh * sw; i += kThreads) {
      const int yy = y0 - pad + r;
      const int xx = x0 - pad + q;
      stage[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                     ? sigmoid_f32(plane[yy * W + xx])
                     : -1.f;
      r += dr;
      q += dq;
      if (q >= sw) {
        q -= sw;
        ++r;
      }
    }
  }
  __syncthreads();

  int ly = threadIdx.x / tile_w, lx = threadIdx.x % tile_w;
  const int dly = kThreads / tile_w, dlx = kThreads % tile_w;
  for (int e = threadIdx.x; e < tile_elems; e += kThreads) {
    const int y = y0 + ly;
    const int x = x0 + lx;
    const float* s = stage + ly * sw + lx;   // the window's top-left cell
    ly += dly;
    lx += dlx;
    if (lx >= tile_w) {
      lx -= tile_w;
      ++ly;
    }
    if (y >= H || x >= W) continue;
    const float v = s[pad * sw + pad];
    if (!(v > 0.f)) continue;
    float m = v;
#pragma unroll
    for (int dy = 0; dy <= 2 * pad; ++dy)
#pragma unroll
      for (int dx = 0; dx <= 2 * pad; ++dx) m = fmaxf(m, s[dy * sw + dx]);
    if (v >= m) {
      // One shared atomic for the survivors of a warp that arrive
      // together: the first reserves their slots, each takes its own.
      const unsigned int alive = __activemask();
      const int lane = threadIdx.x & 31;
      const int leader = __ffs(alive) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&s_count, __popc(alive));
      base = __shfl_sync(alive, base, leader);
      smem_keys[base + __popc(alive & ((1u << lane) - 1u))] =
          make_key(v, (c * H + y) * W + x);
    }
  }
  __syncthreads();
  const int n = s_count;
  const int n_sort = next_pow2(n);
  for (int i = n + threadIdx.x; i < n_sort; i += blockDim.x) smem_keys[i] = 0;
  __syncthreads();
  bitonic_sort_desc(smem_keys, n_sort);

  unsigned long long* out =
      cand + ((long long)b * gridDim.x + blockIdx.x) * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    out[i] = i < n ? smem_keys[i] : 0ull;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const unsigned long long* __restrict__ cand, int n_cand,
             int CHW, int HW, int W, int K, int* __restrict__ index,
             int* __restrict__ label, float* __restrict__ score) {
  __shared__ unsigned long long keys[kMergeKeys];
  __shared__ int warp_count[kThreads / 32];
  const int b = blockIdx.x;
  const unsigned long long* in = cand + (long long)b * n_cand;

  for (int i = threadIdx.x; i < K; i += blockDim.x) keys[i] = 0;
  for (int pos = 0; pos < n_cand;) {
    const int m = min(kMergeKeys - K, n_cand - pos);
    const int n = next_pow2(K + m);
    for (int i = threadIdx.x; i < n - K; i += blockDim.x)
      keys[K + i] = i < m ? in[pos + i] : 0ull;
    __syncthreads();
    bitonic_sort_desc(keys, n);
    pos += m;
  }

  // keys[0, K) is the best K; the first r are positive cells.
  const int r = __syncthreads_count(threadIdx.x < K && keys[threadIdx.x] != 0);
  const long long row0 = (long long)b * K;
  if (threadIdx.x < r) {
    const unsigned long long key = keys[threadIdx.x];
    const int flat = (int)~(unsigned int)key;
    const int cell = flat % HW;
    const long long row = row0 + threadIdx.x;
    score[row] = __uint_as_float((unsigned int)(key >> 32));
    label[row] = flat / HW;
    index[2 * row] = cell / W;
    index[2 * row + 1] = cell % W;
  }
  if (r == K) return;

  // Zero slots r..K-1: the K - r smallest flat indices that are not
  // positive, all below K + r (<= 255 < kThreads).
  const int j = threadIdx.x;
  bool zero = j < K + r && j < CHW;
  for (int i = 0; zero && i < r; ++i)
    zero = (int)~(unsigned int)keys[i] != j;
  const unsigned int ballot = __ballot_sync(0xffffffffu, zero);
  const int lane = j & 31;
  const int warp = j >> 5;
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_count[w];
  if (zero && rank < K - r) {
    const long long row = row0 + r + rank;
    const int cell = j % HW;
    score[row] = 0.f;
    label[row] = j / HW;
    index[2 * row] = cell / W;
    index[2 * row + 1] = cell % W;
  }
}

}  // namespace

// logits [B, C, H, W] f32 contiguous; cand [B, tiles, K] u64 scratch with
// tiles = C * ceil(H / tile_h) * ceil(W / tile_w); index [B, K, 2] i32;
// label [B, K] i32; score [B, K] f32.  Requires 1 <= K <= min(128,
// C*H*W), an odd kernel_size, and tile_h * tile_w <= 4096.  Returns
// cudaGetLastError() after the launches.
extern "C" int tauv_peak_decode_f32(const void* logits, void* cand,
                                    void* index, void* label, void* score,
                                    int B, int C, int H, int W, int K,
                                    int kernel_size, int tile_h, int tile_w,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxK || tile_h < 1 || tile_w < 1 ||
      tile_h * tile_w > kMaxTile || kernel_size < 1 || kernel_size % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const int pad = (kernel_size - 1) / 2;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const int tiles = C * tiles_y * tiles_x;
  const size_t smem =
      (size_t)next_pow2(tile_h * tile_w) * sizeof(unsigned long long) +
      (size_t)(tile_h + 2 * pad) * (tile_w + 2 * pad) * sizeof(float);
  auto* kernel = pad == 1 ? tile_topk_kernel<1> : tile_topk_kernel<-1>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<dim3(tiles, B), kThreads, smem, s>>>(
      (const float*)logits, (unsigned long long*)cand, C, H, W, K, pad,
      tile_h, tile_w, tiles_y, tiles_x);
  merge_kernel<<<B, kThreads, 0, s>>>(
      (const unsigned long long*)cand, tiles * K, C * H * W, H * W, W, K,
      (int*)index, (int*)label, (float*)score);
  return (int)cudaGetLastError();
}
