// Modulated deformable conv v2 (DCNv2), 3x3, stride 1, padding 1,
// dilation 1: the 16 IDA blocks of the DCN-IDA CenterNet.
//
// Replaces tauv_vision_tpu/ops/pallas/deform_conv.py:
// deform_conv2d_pallas (body _dcn_kernel), which samples with a static
// window of hat weights and is exact only for |offset| <= R.  This kernel
// samples directly, with torchvision's semantics: unbounded offsets, each
// bilinear corner outside the map reads zero, the mask multiplies the
// sample.  So it equals the Pallas kernel wherever |offset| <= R and the
// JAX gather formulation (ops/deform_conv.deform_conv2d) everywhere.
//
// What bounds it on Hopper: f32 FMAs on CUDA cores (9 C O of them for
// each output pixel, ~12.6 GFLOP a 640x360 frame over the 16 calls) and
// the bilinear gathers that feed them, 4 scattered reads from L2 / L1
// for each (pixel, tap, input channel), which an im2col GEMM would not
// need.  The design keeps every sample out of device memory:
//
// - a block owns 64 consecutive output pixels of one image x 64 output
//   channels, 256 threads, each accumulating a 4 x 4 register tile
//   (pixels tp, tp + 16, tp + 32, tp + 48 x outputs 4 to .. 4 to + 3);
// - for each of the 9 taps, 64 threads compute each pixel's 4 corner
//   indices and bilinear weights x mask once, into shared memory
//   (a corner outside the map gets index -1 and weight 0);
// - then for each chunk of 16 input channels, all threads gather the
//   sampled [16 x 64] tile into shared memory and load
//   weight[o0 .. o0 + 63, chunk, ky, kx] beside it (rows padded to 68
//   floats: 2-way bank conflicts on the store, 16-byte aligned float4
//   reads), and every thread runs 16 x 16 FMAs from shared memory;
// - the epilogue adds the bias and writes NCHW, consecutive threads on
//   consecutive pixels.
// Shared memory is ~10.5 KB a block.  Tensor cores, cp.async / TMA and a
// sampled tile shared across the output-channel blocks are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileP = 64;    // output pixels a block
constexpr int kTileO = 64;    // output channels a block
constexpr int kChunkC = 16;   // input channels a shared-memory chunk
constexpr int kThreads = 256;
constexpr int kRowW = kTileO + 4;  // padded weight row (floats)
constexpr int kTaps = 9;

__global__ void __launch_bounds__(kThreads)
deform_conv_kernel(const float* __restrict__ x,
                   const float* __restrict__ offset,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int C, int H, int W, int O) {
  __shared__ int s_idx[4][kTileP];
  __shared__ float s_wt[4][kTileP];
  __shared__ float s_x[kChunkC][kTileP];
  __shared__ __align__(16) float s_w[kChunkC][kRowW];

  const int HW = H * W;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * kTileP;
  const int o0 = blockIdx.y * kTileO;
  const int tid = threadIdx.x;
  const int tp = tid % 16;
  const int to = tid / 16;

  const float* xb = x + (long long)b * C * HW;
  const float* offb = offset + (long long)b * 2 * kTaps * HW;
  const float* maskb = mask ? mask + (long long)b * kTaps * HW : nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < kTaps; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    __syncthreads();  // the previous tap's corners are no longer read
    if (tid < kTileP) {
      const int p = p0 + tid;
      int idx[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < HW) {
        const int oy = p / W, ox = p % W;
        const float y = (float)(oy - 1 + ky) + offb[(2 * tap) * HW + p];
        const float xx = (float)(ox - 1 + kx) + offb[(2 * tap + 1) * HW + p];
        const float m = maskb ? maskb[tap * HW + p] : 1.f;
        const float y0 = floorf(y), x0 = floorf(xx);
        const float ly = y - y0, lx = xx - x0;
        const float hy = 1.f - ly, hx = 1.f - lx;
        const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
        const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
        const float cw[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // Compared as floats, so any finite offset is safe to convert.
          if (cy[k] >= 0.f && cy[k] <= (float)(H - 1) && cx[k] >= 0.f &&
              cx[k] <= (float)(W - 1)) {
            idx[k] = (int)cy[k] * W + (int)cx[k];
            wt[k] = cw[k] * m;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_idx[k][tid] = idx[k];
        s_wt[k][tid] = wt[k];
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += kChunkC) {
      // Sampled tile: element e -> (channel c0 + e / 64, pixel e % 64).
      for (int e = tid; e < kChunkC * kTileP; e += kThreads) {
        const int cc = e / kTileP, pp = e % kTileP;
        const int c = c0 + cc;
        float v = 0.f;
        if (c < C) {
          const float* xc = xb + (long long)c * HW;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = s_idx[k][pp];
            if (i >= 0) v = fmaf(s_wt[k][pp], __ldg(xc + i), v);
          }
        }
        s_x[cc][pp] = v;
      }
      // Weight tile: element e -> (output o0 + e / 16, channel c0 + e % 16);
      // neighbouring threads read neighbouring channels (9 floats apart).
      for (int e = tid; e < kChunkC * kTileO; e += kThreads) {
        const int oo = e / kChunkC, cc = e % kChunkC;
        const int o = o0 + oo, c = c0 + cc;
        s_w[cc][oo] = (o < O && c < C)
                          ? __ldg(weight + ((long long)o * C + c) * kTaps + tap)
                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kChunkC; ++cc) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_x[cc][tp + 16 * i];
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[cc][4 * to]);
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wr[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + 4 * to + j;
    if (o >= O) continue;
    const float bo = bias ? bias[o] : 0.f;
    float* outo = out + ((long long)b * O + o) * HW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + tp + 16 * i;
      if (p < HW) outo[p] = acc[i][j] + bo;
    }
  }
}

}  // namespace

// x [B, C, H, W], offset [B, 18, H, W] ((dy, dx) per tap, taps
// row-major), mask [B, 9, H, W] or null, weight [O, C, 3, 3], bias [O]
// or null, out [B, O, H, W]; all f32 contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int tauv_deform_conv_f32(const void* x, const void* offset,
                                    const void* mask, const void* weight,
                                    const void* bias, void* out, int B, int C,
                                    int H, int W, int O, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H * W + kTileP - 1) / kTileP, (O + kTileO - 1) / kTileO, B);
  deform_conv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)offset, (const float*)mask,
      (const float*)weight, (const float*)bias, (float*)out, C, H, W, O);
  return (int)cudaGetLastError();
}
