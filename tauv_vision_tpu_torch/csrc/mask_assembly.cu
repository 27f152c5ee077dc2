// YOLACT mask assembly: sigmoid(coeff[K, P] @ proto[P, H, W]) times the
// inclusive pixel-unit box crop, per image.
//
// Replaces tauv_vision_tpu/ops/pallas/mask_assembly.py:assemble_mask_pallas
// (kernel _mask_assembly_kernel), the drop-in twin of
// ops/masks.assemble_mask_batch.
//
// What bounds it on Hopper: its writes.  On the main path each image
// writes K x H x W = 20 x 180 x 320 f32 = 4.6 MB of masks and reads only
// 8 x 180 x 320 f32 = 1.8 MB of prototypes, with P = 8 FMAs per output.
// So one thread owns one pixel of one image: it loads the P prototype
// values once into registers, then for each of the K detections does P
// FMAs, the sigmoid and the crop, and stores; neighbouring threads store
// neighbouring pixels, so every store is coalesced.  The coefficients
// and the four crop edges of each detection sit in shared memory.
//
// The crop reproduces ops/boxes.box_to_mask to the bit, since its
// inclusive edges flip whole pixel rows or columns on one ulp:
// cy = y*h, bh = hh*h, top = cy - bh/2, bottom = cy + bh/2 (and the same
// for x), each rounded on its own: __fmul_rn/__fdiv_rn/__fsub_rn/
// __fadd_rn keep nvcc from contracting a*b - c into an FMA.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 32;

__global__ void mask_assembly_kernel(const float* __restrict__ proto,
                                     const float* __restrict__ coeff,
                                     const float* __restrict__ box,
                                     float* __restrict__ out, int P, int K,
                                     int H, int W) {
  extern __shared__ float smem[];
  float* s_coeff = smem;          // [K, P]
  float* s_edge = smem + K * P;   // [K, 4]: top, bottom, left, right
  const int b = blockIdx.y;
  for (int t = threadIdx.x; t < K * P; t += blockDim.x)
    s_coeff[t] = coeff[(long long)b * K * P + t];
  if (box != nullptr) {
    const float fh = (float)H;
    const float fw = (float)W;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float* bx = box + ((long long)b * K + k) * 4;
      const float cy = __fmul_rn(bx[0], fh);
      const float cx = __fmul_rn(bx[1], fw);
      const float half_h = __fdiv_rn(__fmul_rn(bx[2], fh), 2.f);
      const float half_w = __fdiv_rn(__fmul_rn(bx[3], fw), 2.f);
      s_edge[4 * k + 0] = __fsub_rn(cy, half_h);
      s_edge[4 * k + 1] = __fadd_rn(cy, half_h);
      s_edge[4 * k + 2] = __fsub_rn(cx, half_w);
      s_edge[4 * k + 3] = __fadd_rn(cx, half_w);
    }
  }
  __syncthreads();

  const int HW = H * W;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;

  float pr[kMaxP];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p)
    if (p < P) pr[p] = proto[((long long)b * P + p) * HW + pix];

  const float fy = (float)(pix / W);
  const float fx = (float)(pix % W);
  float* o = out + (long long)b * K * HW + pix;
  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxP; ++p)
      if (p < P) acc = fmaf(s_coeff[k * P + p], pr[p], acc);
    float m = 1.f / (1.f + expf(-acc));
    if (box != nullptr) {
      const float* e = s_edge + 4 * k;
      const bool inside =
          fy >= e[0] && fy <= e[1] && fx >= e[2] && fx <= e[3];
      m = m * (inside ? 1.f : 0.f);
    }
    o[(long long)k * HW] = m;
  }
}

}  // namespace

// proto [B, P, H, W], coeff [B, K, P], box [B, K, 4] (y, x, h, w
// normalised) or null for no crop, out [B, K, H, W]; all f32 contiguous.
// Requires P <= 32.  Returns cudaGetLastError() after the launch.
extern "C" int tauv_mask_assembly_f32(const void* proto, const void* coeff,
                                      const void* box, void* out, int B,
                                      int P, int K, int H, int W, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P > kMaxP) return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)K * (P + 4) * sizeof(float);
  mask_assembly_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)proto, (const float*)coeff, (const float*)box,
      (float*)out, P, K, H, W);
  return (int)cudaGetLastError();
}
