// Heatmap peak decode: sigmoid -> 3x3 max-pool-equality NMS -> flat top-K.
//
// Replaces tauv_vision_tpu/ops/pallas/peak_decode.py:peak_decode_pallas
// (kernel _peak_decode_kernel), the drop-in twin of ops/peaks.peak_decode.
//
// What bounds it on Hopper: nothing heavy.  The main-path map is
// [B, 4, 90, 160] f32, 230,400 B per image: it does not fit a block's
// shared memory with any headroom, so the design never tries to hold it
// there.  Two launches:
//   1. nms_kernel, one thread per cell over the whole batch: sigmoid of
//      the cell and its 3x3 neighbours (recomputed, 9 expf a cell), keep
//      the probability where it is >= every in-range neighbour, else 0.
//      It reads the logits once and writes the suppressed map once to a
//      scratch buffer the wrapper allocates (memory bound, ~2 x 230 KB a
//      image).
//   2. topk_kernel, one 1024-thread block per image: K rounds of a block
//      arg-max over the suppressed map, which stays in L2 between rounds.
//      Round r takes the best element strictly after round r-1's pick in
//      the total order (score descending, flat index ascending), so no
//      element is ever overwritten and ties go to the smallest flat index,
//      the rule of jax.lax.top_k and of the Pallas kernel.
// The NMS compares probabilities, not logits: sigmoid maps distinct large
// logits to the same f32 1.0, and those must tie as they do in the
// reference.  The sigmoid is 1/(1+expf(-x)) (no fast math), the formula
// PyTorch's own CUDA sigmoid uses.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kNmsThreads = 256;
constexpr int kTopkThreads = 1024;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void nms_kernel(const float* __restrict__ logits,
                           float* __restrict__ suppressed, long long total,
                           int H, int W, int pad) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int x = (int)(i % W);
    const long long t = i / W;
    const int y = (int)(t % H);
    const float* plane = logits + (t / H) * (long long)H * W;
    const float v = sigmoid_f32(plane[y * W + x]);
    float m = v;
    for (int dy = -pad; dy <= pad; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= H) continue;
      for (int dx = -pad; dx <= pad; ++dx) {
        const int xx = x + dx;
        if (xx < 0 || xx >= W || (dy == 0 && dx == 0)) continue;
        m = fmaxf(m, sigmoid_f32(plane[yy * W + xx]));
      }
    }
    suppressed[i] = (v >= m) ? v : 0.f;
  }
}

// (av, ai) comes before (bv, bi) in the top-k order.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void topk_kernel(const float* __restrict__ suppressed, int n,
                            int HW, int W, int K, int* __restrict__ index,
                            int* __restrict__ label,
                            float* __restrict__ score) {
  const float* s = suppressed + (long long)blockIdx.x * n;
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ float prev_v;
  __shared__ int prev_i;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    prev_v = INFINITY;
    prev_i = -1;
  }
  __syncthreads();
  for (int r = 0; r < K; ++r) {
    const float pv = prev_v;
    const int pi = prev_i;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float v = s[j];
      const bool after_prev = v < pv || (v == pv && j > pi);
      if (after_prev && before(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < n_warps ? warp_v[lane] : -INFINITY;
      bi = lane < n_warps ? warp_i[lane] : INT_MAX;
      warp_best(bv, bi);
      if (lane == 0) {
        prev_v = bv;
        prev_i = bi;
        const long long row = (long long)blockIdx.x * K + r;
        const int cell = bi % HW;
        score[row] = bv;
        label[row] = bi / HW;
        index[2 * row] = cell / W;
        index[2 * row + 1] = cell % W;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// logits [B, C, H, W] f32 contiguous; scratch [B, C, H, W] f32;
// index [B, K, 2] i32; label [B, K] i32; score [B, K] f32.
// Requires K <= C*H*W.  Returns cudaGetLastError() after the launches.
extern "C" int tauv_peak_decode_f32(const void* logits, void* scratch,
                                    void* index, void* label, void* score,
                                    int B, int C, int H, int W, int K,
                                    int kernel_size, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)B * C * H * W;
  long long blocks = (total + kNmsThreads - 1) / kNmsThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  nms_kernel<<<(unsigned)blocks, kNmsThreads, 0, s>>>(
      (const float*)logits, (float*)scratch, total, H, W,
      (kernel_size - 1) / 2);
  topk_kernel<<<B, kTopkThreads, 0, s>>>(
      (const float*)scratch, C * H * W, H * W, W, K, (int*)index,
      (int*)label, (float*)score);
  return (int)cudaGetLastError();
}
