// Depthwise (groups = C) ConvTranspose2d(kernel 2f, stride f, padding
// f/2, no bias): the trainable bilinear upsample of DLAUp / IDAUp.
//
// Replaces tauv_vision_tpu/ops/pallas/depthwise_upsample.py:
// depthwise_upsample_pallas (body kernel_fn), the zero-free twin of
// DepthwiseUpsample's dilated lowering.
//
// What bounds it on Hopper: memory.  Each output element needs 4 FMAs
// and one store, and the input is a quarter (f = 2) or less of the
// output, so the kernel moves ~1.25x (f = 2) the output's bytes; at the
// largest main-path instance ([B, 64, 45, 80] -> [B, 64, 90, 160]) that
// is 3.7 MB of f32 stores per image, half that in bf16.  The phase form
// is zero-free: an output pixel oy sees exactly the two input rows iy =
// q and q - 1, where q = (oy + f/2) div f, through kernel rows r and
// r + f, r = (oy + f/2) mod f (the same for x), so each output is 2 x 2
// taps, accumulated in f32 in the order a = 0 (b = 0, then b = 1), then
// a = 1, skipping taps past the edge.  No dilated zeros are multiplied.
// NCHW in and out, which is the port's layout; general in f.
//
// The design is a tiled vector pass:
//   - output rows fall in groups of f that read the same two input rows
//     (group q: rows q f - f/2 .. q f - f/2 + f - 1, input rows q and
//     q - 1, kernel rows r and r + f for r = 0 .. f - 1);
//   - a block owns one plane (b * C + c) and a band of about 64 output
//     rows (whole groups) x 256 output columns, decoded from blockIdx
//     once in 32-bit integers, and stages the plane's 2f x 2f weights in
//     shared memory;
//   - each thread takes one group and a run of 8 consecutive output
//     columns and writes its f x 8 outputs, each row of the run as one
//     16-byte vector (bf16) or two (f32), a masked element store where
//     the run passes a ragged row end or rows are not 16-byte multiples.
//     f is a template argument (1, 2, 4 or 8: the factors that divide the
//     run; DLA-34's are 2, 4 and 8), the run starts at r = f/2 of column
//     q = x / f, and every step along it is a constant: the run's 8 / f +
//     2 input columns of both rows are loaded into registers at once (all
//     in flight together, from L1 where neighbouring runs share them) and
//     serve all f rows.  No division and no 64-bit arithmetic is in the
//     loop but the run's one.
//     Input rows are not staged in shared memory: a staging loop waits a
//     memory latency for each element it stores, and measured slower.
//
// Two element types from one template: f32, and bf16 as the bf16
// CenterNet serves it (input and weight bf16, as the dilated lowering
// casts both; the 4 taps accumulate in f32 and the sum is rounded once
// to bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBandRows = 64;    // output rows a block, whole groups of f
constexpr int kBandCols = 256;   // output columns a block
constexpr int kRun = 8;          // outputs a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_run(float* p, const float (&v)[kRun],
                                          bool whole, int n) {
  if (whole) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int i = 0; i < n; ++i) p[i] = v[i];
  }
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&v)[kRun], bool whole,
                                          int n) {
  if (whole) {
    uint4 u;
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i].x = __float2bfloat16_rn(v[2 * i]);
      h[i].y = __float2bfloat16_rn(v[2 * i + 1]);
    }
    u.x = *reinterpret_cast<uint32_t*>(&h[0]);
    u.y = *reinterpret_cast<uint32_t*>(&h[1]);
    u.z = *reinterpret_cast<uint32_t*>(&h[2]);
    u.w = *reinterpret_cast<uint32_t*>(&h[3]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    for (int i = 0; i < n; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// The call's sizes: plane count C, input H x W, output Ho x Wo, and its
// row groups, bands of groups and bands of columns.
struct Dims {
  int C, H, W, Ho, Wo, n_groups, band_groups, n_row_bands, n_col_bands;
};

// F: the factor, 1, 2, 4 or 8 (a divisor of the 8-output run).
template <typename T, int F>
__global__ void __launch_bounds__(kThreads) depthwise_upsample_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    Dims d) {
  static_assert(kRun % F == 0, "F must divide the run");
  constexpr int k = 2 * F;
  constexpr int kX = kRun / F + 2;   // input columns a run reads
  __shared__ float ws[k * k];
  const int bands = d.n_row_bands * d.n_col_bands;
  const int plane = blockIdx.x / bands;   // b * C + c
  const int band = blockIdx.x - plane * bands;
  const int rb = band / d.n_col_bands, cb = band - rb * d.n_col_bands;
  const int q0 = rb * d.band_groups, q1 = min(q0 + d.band_groups, d.n_groups);
  const int ox0 = cb * kBandCols, ox1 = min(ox0 + kBandCols, d.Wo);
  const int runs = (ox1 - ox0 + kRun - 1) / kRun;

  const int tid = threadIdx.x;
  const T* wp = w + (long long)(plane % d.C) * k * k;
  for (int i = tid; i < k * k; i += kThreads) ws[i] = to_f32(wp[i]);
  __syncthreads();

  const int H = d.H, W = d.W, Ho = d.Ho, Wo = d.Wo;
  const T* xp = x + (long long)plane * H * W;
  T* op = out + (long long)plane * Ho * Wo;
  const bool aligned = Wo * (int)sizeof(T) % 16 == 0;   // rows of 16-byte vectors
  for (int i = tid; i < (q1 - q0) * runs; i += kThreads) {
    const int g = i / runs;
    const int q = q0 + g, ox = ox0 + (i - g * runs) * kRun;
    const bool in0 = q < H, in1 = q >= 1 && q - 1 < H;   // input rows q, q - 1
    const int row0 = q * W, row1 = row0 - W;
    // ox is a multiple of 8 and so of F: the run starts at column
    // qx0 = ox / F, r = F / 2, and reads columns qx0 - 1 .. qx0 + 8 / F.
    const int qx0 = ox / F;
    float xa[kX], xb[kX];
    bool ok[kX];
#pragma unroll
    for (int e = 0; e < kX; ++e) {
      const int ix = qx0 - 1 + e;
      ok[e] = ix >= 0 && ix < W;
      xa[e] = in0 && ok[e] ? to_f32(xp[row0 + ix]) : 0.f;
      xb[e] = in1 && ok[e] ? to_f32(xp[row1 + ix]) : 0.f;
    }
    const int n = min(kRun, Wo - ox);
#pragma unroll
    for (int ry = 0; ry < F; ++ry) {
      const int oy = q * F - F / 2 + ry;
      if (oy < 0 || oy >= Ho) continue;
      const float* w0 = ws + ry * k;
      const float* w1 = w0 + F * k;
      float v[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int e = (F / 2 + j) / F + 1, rx = (F / 2 + j) % F;   // column q of output j
        float acc = 0.f;
        if (in0) {
          if (ok[e]) acc = fmaf(xa[e], w0[rx], acc);
          if (ok[e - 1]) acc = fmaf(xa[e - 1], w0[rx + F], acc);
        }
        if (in1) {
          if (ok[e]) acc = fmaf(xb[e], w1[rx], acc);
          if (ok[e - 1]) acc = fmaf(xb[e - 1], w1[rx + F], acc);
        }
        v[j] = acc;
      }
      store_run(op + oy * Wo + ox, v, aligned && n == kRun, n);
    }
  }
}

template <typename T>
int launch(const void* x, const void* weight, void* out, int B, int C, int H,
           int W, int f, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (f != 1 && f != 2 && f != 4 && f != 8) return (int)cudaErrorInvalidValue;
  const int pad = f / 2;
  const int Ho = (H - 1) * f - 2 * pad + 2 * f;
  const int Wo = (W - 1) * f - 2 * pad + 2 * f;
  if ((long long)Ho * Wo > INT_MAX || (long long)H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_groups = (Ho - 1 + pad) / f + 1;
  const int band_groups = kBandRows / f;
  const Dims d{C, H, W, Ho, Wo, n_groups, band_groups,
               (n_groups + band_groups - 1) / band_groups,
               (Wo + kBandCols - 1) / kBandCols};
  const long long blocks = (long long)B * C * d.n_row_bands * d.n_col_bands;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(weight);
  T* ot = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
    case 1: depthwise_upsample_kernel<T, 1><<<grid, kThreads, 0, s>>>(xt, wt, ot, d); break;
    case 2: depthwise_upsample_kernel<T, 2><<<grid, kThreads, 0, s>>>(xt, wt, ot, d); break;
    case 4: depthwise_upsample_kernel<T, 4><<<grid, kThreads, 0, s>>>(xt, wt, ot, d); break;
    default: depthwise_upsample_kernel<T, 8><<<grid, kThreads, 0, s>>>(xt, wt, ot, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, C, H, W], weight [C, 1, 2f, 2f], out [B, C, Ho, Wo] with
// Ho = (H - 1) f - 2 (f/2) + 2f; all contiguous and 16-byte aligned, all
// f32 or all bf16; f = 1, 2, 4 or 8.  Returns cudaErrorInvalidValue for
// an f or a plane it does not take, else cudaGetLastError() after the
// launch.
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
