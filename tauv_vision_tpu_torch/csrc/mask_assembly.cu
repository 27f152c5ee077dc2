// YOLACT mask assembly: sigmoid(coeff[K, P] @ proto[P, H, W]) times the
// inclusive pixel-unit box crop, per image.
//
// Replaces tauv_vision_tpu/ops/pallas/mask_assembly.py:assemble_mask_pallas
// (kernel _mask_assembly_kernel), the drop-in twin of
// ops/masks.assemble_mask_batch.
//
// What bounds it on Hopper: its writes.  On the main path each image
// writes K x H x W = 20 x 180 x 320 f32 = 4.6 MB of masks and reads only
// 8 x 180 x 320 f32 = 1.8 MB of prototypes, with P = 8 FMAs an output.
// So one thread owns 4 neighbouring pixels of one row: it loads their P
// prototype values once into registers (16-byte loads), then for each of
// the K detections does exactly 4 x kP FMAs (kP a template parameter, 8
// on the main path) with the coefficients read from shared memory as
// broadcast float4, the sigmoids and the crop, and writes the 4 masks as
// one 16-byte store; neighbouring threads store neighbouring 16 bytes.
// The crop's row test comes first, once a thread and detection: a row
// outside the box stores zeros without the dot or the sigmoid.
//
// Prototype layouts: [B, P, H, W] NCHW-contiguous, or the NHWC view
// (permute(0, 3, 1, 2) of a contiguous [B, H, W, P]) in which the int8
// chain makes them; there a pixel's 8 prototypes are 32 contiguous
// bytes, two float4 loads, and the chain needs no copy.  A P below kP
// (8, 16 or 32) runs the next size with zero coefficients.  A W that is
// not a multiple of 4, or an unaligned pointer, takes the scalar
// instantiation (kVec false): the same arithmetic, masked 4-byte loads
// and stores.
//
// The crop reproduces ops/boxes.box_to_mask to the bit, since its
// inclusive edges flip whole pixel rows or columns on one ulp:
// cy = y*h, bh = hh*h, top = cy - bh/2, bottom = cy + bh/2 (and the same
// for x), each rounded on its own: __fmul_rn/__fdiv_rn/__fsub_rn/
// __fadd_rn keep nvcc from contracting a*b - c into an FMA.  A pixel
// outside the box stores +0, as the plain version's sigmoid x 0 does.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;       // pixels a thread, one float4 store
constexpr int kMaxP = 32;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

// Dynamic shared memory: the K crop edges as float4 (top, bottom, left,
// right), then the coefficients [K][kP], zero past P.
template <int kP, bool kNHWC, bool kVec>
__global__ void __launch_bounds__(kThreads)
mask_assembly_kernel(const float* __restrict__ proto,
                     const float* __restrict__ coeff,
                     const float* __restrict__ box, float* __restrict__ out,
                     int P, int K, int H, int W) {
  extern __shared__ float4 smem[];
  float4* s_edge = smem;
  float* s_coeff = (float*)(smem + K);
  const int b = blockIdx.y;
  for (int t = threadIdx.x; t < K * kP; t += blockDim.x) {
    const int k = t / kP;
    const int p = t % kP;
    s_coeff[t] = p < P ? coeff[((long long)b * K + k) * P + p] : 0.f;
  }
  if (box != nullptr) {
    const float fh = (float)H;
    const float fw = (float)W;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float* bx = box + ((long long)b * K + k) * 4;
      const float cy = __fmul_rn(bx[0], fh);
      const float cx = __fmul_rn(bx[1], fw);
      const float half_h = __fdiv_rn(__fmul_rn(bx[2], fh), 2.f);
      const float half_w = __fdiv_rn(__fmul_rn(bx[3], fw), 2.f);
      s_edge[k] = make_float4(__fsub_rn(cy, half_h), __fadd_rn(cy, half_h),
                              __fsub_rn(cx, half_w), __fadd_rn(cx, half_w));
    }
  }
  __syncthreads();

  const int groups = (W + kPix - 1) / kPix;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= H * groups) return;
  const int y = g / groups;
  const int x0 = (g % groups) * kPix;
  const long long HW = (long long)H * W;

  // pr[j][p]: prototype p of pixel x0 + j; 0 past P and past the row.
  float pr[kPix][kP];
  const float* base = proto + (long long)b * P * HW;
  if (kNHWC) {
    const float* px = base + ((long long)y * W + x0) * P;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const bool in_row = x0 + j < W;
#pragma unroll
      for (int p = 0; p < kP; p += 4) {
        if (kVec) {
          const float4 v = (in_row && p < P)
                               ? *(const float4*)(px + j * P + p)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          pr[j][p] = v.x;
          pr[j][p + 1] = v.y;
          pr[j][p + 2] = v.z;
          pr[j][p + 3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pr[j][p + q] = (in_row && p + q < P) ? px[j * P + p + q] : 0.f;
        }
      }
    }
  } else {
    const float* px = base + (long long)y * W + x0;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (kVec) {
        const float4 v = p < P ? *(const float4*)(px + p * HW)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        pr[0][p] = v.x;
        pr[1][p] = v.y;
        pr[2][p] = v.z;
        pr[3][p] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          pr[j][p] = (p < P && x0 + j < W) ? px[p * HW + j] : 0.f;
      }
    }
  }

  const float fy = (float)y;
  float* o = out + (long long)b * K * HW + (long long)y * W + x0;
  for (int k = 0; k < K; ++k, o += HW) {
    float m[kPix] = {0.f, 0.f, 0.f, 0.f};
    const bool crop = box != nullptr;
    const float4 e = crop ? s_edge[k] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (!crop || (fy >= e.x && fy <= e.y)) {
      float acc[kPix] = {0.f, 0.f, 0.f, 0.f};
      const float4* c4 = (const float4*)(s_coeff + k * kP);
#pragma unroll
      for (int p4 = 0; p4 < kP / 4; ++p4) {
        const float4 c = c4[p4];
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          acc[j] = fmaf(c.x, pr[j][4 * p4], acc[j]);
          acc[j] = fmaf(c.y, pr[j][4 * p4 + 1], acc[j]);
          acc[j] = fmaf(c.z, pr[j][4 * p4 + 2], acc[j]);
          acc[j] = fmaf(c.w, pr[j][4 * p4 + 3], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        m[j] = sigmoid_f32(acc[j]);
        if (crop) {
          const float fx = (float)(x0 + j);
          m[j] = m[j] * ((fx >= e.z && fx <= e.w) ? 1.f : 0.f);
        }
      }
    }
    if (kVec) {
      *(float4*)o = make_float4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (x0 + j < W) o[j] = m[j];
    }
  }
}

template <int kP>
cudaError_t launch(bool nhwc, bool vec, dim3 grid, size_t smem,
                   cudaStream_t s, const float* proto, const float* coeff,
                   const float* box, float* out, int P, int K, int H, int W) {
  auto* kernel = nhwc ? (vec ? mask_assembly_kernel<kP, true, true>
                             : mask_assembly_kernel<kP, true, false>)
                      : (vec ? mask_assembly_kernel<kP, false, true>
                             : mask_assembly_kernel<kP, false, false>);
  kernel<<<grid, kThreads, smem, s>>>(proto, coeff, box, out, P, K, H, W);
  return cudaGetLastError();
}

}  // namespace

// proto [B, P, H, W] f32, NCHW-contiguous (nhwc = 0) or the NHWC view of
// a contiguous [B, H, W, P] (nhwc = 1); coeff [B, K, P], box [B, K, 4]
// (y, x, h, w normalised) or null for no crop, out [B, K, H, W]; coeff,
// box and out f32 contiguous.  Requires 1 <= P <= 32.  Returns
// cudaGetLastError() after the launch.
extern "C" int tauv_mask_assembly_f32(const void* proto, const void* coeff,
                                      const void* box, void* out, int B,
                                      int P, int K, int H, int W, int nhwc,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  const int kp = P <= 8 ? 8 : (P <= 16 ? 16 : 32);
  const size_t smem = (size_t)K * (4 + kp) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // float4 loads and stores: whole 4-pixel groups in every row, 16-byte
  // aligned bases, and in NHWC whole float4s of a pixel's prototypes.
  const bool vec = W % 4 == 0 && (!nhwc || P % 4 == 0) &&
                   (uintptr_t)proto % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int groups = (W + kPix - 1) / kPix;
  const dim3 grid((H * groups + kThreads - 1) / kThreads, B);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pp = (const float*)proto;
  const auto* cp = (const float*)coeff;
  const auto* bp = (const float*)box;
  auto* op = (float*)out;
  if (kp == 8) err = launch<8>(nhwc, vec, grid, smem, s, pp, cp, bp, op, P, K, H, W);
  else if (kp == 16) err = launch<16>(nhwc, vec, grid, smem, s, pp, cp, bp, op, P, K, H, W);
  else err = launch<32>(nhwc, vec, grid, smem, s, pp, cp, bp, op, P, K, H, W);
  return (int)err;
}
