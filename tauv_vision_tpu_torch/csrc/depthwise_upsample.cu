// Depthwise (groups = C) ConvTranspose2d(kernel 2f, stride f, padding
// f/2, no bias): the trainable bilinear upsample of DLAUp / IDAUp.
//
// Replaces tauv_vision_tpu/ops/pallas/depthwise_upsample.py:
// depthwise_upsample_pallas (body kernel_fn), the zero-free twin of
// DepthwiseUpsample's dilated lowering.
//
// What bounds it on Hopper: memory.  Each output element needs 4 FMAs
// and one store, and the input is a quarter (f = 2) or a sixteenth
// (f = 4) of the output, so the kernel moves ~1.25x (f = 2) the output's
// bytes; at the largest main-path instance ([B, 64, 45, 80] ->
// [B, 64, 90, 160]) that is 3.7 MB of f32 stores per image, half that in
// bf16.  The design is the zero-free phase form: an output pixel oy sees
// exactly the two input rows iy = q and q - 1, where q = (oy + f/2) div
// f, through kernel rows r and r + f, r = (oy + f/2) mod f (the same for
// x), so each thread computes one output pixel from 2 x 2 taps,
// accumulated in f32, and threads that are neighbours in x store
// neighbouring addresses.  No dilated zeros are multiplied.  NCHW in and
// out, which is the port's layout; general in f.
//
// Two element types from one template: f32, and bf16 as the bf16
// CenterNet serves it (input and weight bf16, as the dilated lowering
// casts both; the 4 taps accumulate in f32 and the sum is rounded once
// to bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void depthwise_upsample_kernel(const T* __restrict__ x,
                                          const T* __restrict__ w,
                                          T* __restrict__ out,
                                          long long total, int C, int H,
                                          int W, int Ho, int Wo, int f) {
  const int k = 2 * f;
  const int pad = f / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int ox = (int)(i % Wo);
    const long long t = i / Wo;
    const int oy = (int)(t % Ho);
    const long long plane = t / Ho;  // b * C + c
    const int c = (int)(plane % C);
    const T* xp = x + plane * H * W;
    const T* wp = w + (long long)c * k * k;
    const int qy = (oy + pad) / f, ry = (oy + pad) % f;
    const int qx = (ox + pad) / f, rx = (ox + pad) % f;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int iy = qy - a;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int ix = qx - bb;
        if (ix < 0 || ix >= W) continue;
        acc = fmaf(to_f32(xp[iy * W + ix]),
                   to_f32(wp[(ry + a * f) * k + rx + bb * f]), acc);
      }
    }
    store(out + i, acc);
  }
}

template <typename T>
int launch(const void* x, const void* weight, void* out, int B, int C, int H,
           int W, int f, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Ho = (H - 1) * f - 2 * (f / 2) + 2 * f;
  const int Wo = (W - 1) * f - 2 * (f / 2) + 2 * f;
  const long long total = (long long)B * C * Ho * Wo;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  depthwise_upsample_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const T*)x, (const T*)weight, (T*)out, total, C, H, W, Ho, Wo, f);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, C, H, W], weight [C, 1, 2f, 2f], out [B, C, Ho, Wo] with
// Ho = (H - 1) f - 2 (f/2) + 2f; all contiguous, all f32 or all bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int tauv_depthwise_upsample_f32(const void* x, const void* weight,
                                           void* out, int B, int C, int H,
                                           int W, int f, int device,
                                           void* stream) {
  return launch<float>(x, weight, out, B, C, H, W, f, device, stream);
}

extern "C" int tauv_depthwise_upsample_bf16(const void* x, const void* weight,
                                            void* out, int B, int C, int H,
                                            int W, int f, int device,
                                            void* stream) {
  return launch<__nv_bfloat16>(x, weight, out, B, C, H, W, f, device, stream);
}
