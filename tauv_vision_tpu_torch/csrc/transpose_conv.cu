// Int8 k3 s2 p1 op1 transposed convolution with the chain's epilogue
// fused: [B, H, W, C] int8 (NHWC) -> [B, 2H, 2W, O], out = requant(act(
// acc * deq[o] + bias[o])) as int8 by out_scale[o], or the activated
// float map as bf16 or f32.  The YOLACT protonet's two 2x upsamples in
// the int8 chain.
//
// Replaces tauv_vision_tpu/ops/pallas/transpose_conv.py:
// transpose_conv2x_int8_pallas (body kernel_fn).
//
// Phase form: output pixel (2m + py, 2n + px) sees only the taps of its
// phase (1, 2, 2 and 4 of the 9; phase_tap_matrices in
// ops/transpose_conv.py):
//   ee = x[m,n] k11
//   eo = x[m,n] k12 + x[m,n+1] k10
//   oe = x[m,n] k21 + x[m+1,n] k01
//   oo = x[m,n] k22 + x[m,n+1] k20 + x[m+1,n] k02 + x[m+1,n+1] k00
// with row m+1 and column n+1 reading zero past the edge.  No dilation
// zero is multiplied.
//
// What bounds it on Hopper: operations.  At the served shapes (C = O =
// 256) each output needs 2.25 C multiply-adds and one store of 1 byte
// (int8 out), so the work is 2 * 9 * B * H * W * C * O operations
// against ~5 * B * H * W * C bytes: far above the card's ridge point.
// The bound is the tensor cores' int8 rate; this first kernel runs on
// the CUDA cores instead, with __dp4a (four int8 products a step into
// an int32), and is far from that bound by design.  Its design:
//   - a block owns one input row m (output rows 2m, 2m+1), 32 input
//     columns and 64 output channels; 8 warps, warp w owns columns
//     4w..4w+3, lane l owns output channels l and l + 32, so a thread
//     holds 4 columns x 2 channels x 4 phases = 32 int32 accumulators;
//   - input channels are walked in chunks of 64 (16 words): the two
//     input rows (33 columns with the halo) and the chunk's taps are
//     staged in shared memory; the taps come from global memory already
//     laid out [C/4][9][O] words (the wrapper builds it), so both the
//     global reads and the shared stores are unit stride, and in the
//     inner loop every lane of a warp reads the same input word (a
//     broadcast) and consecutive tap words (no bank conflict);
//   - integer accumulation is exact, so any order gives the JAX
//     accumulator; the epilogue is __fmaf_rn(acc, deq, bias): one
//     rounding, as XLA contracts `acc * deq + bias` in the compiled JAX
//     graph (and torch.addcmul in the plain version), then leaky
//     (0.01 y) or relu, then rint (half to even, as jnp.round) of an
//     IEEE division and a clamp to [-127, 127], or __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;              // input columns a thread
constexpr int kTW = 8 * kCols;        // input columns a block
constexpr int kTO = 64;               // output channels a block
constexpr int kKW = 16;               // channel words (x4 channels) a chunk

enum Act { kNone = 0, kLeaky = 1, kRelu = 2 };
enum OutKind { kInt8 = 0, kBf16 = 1, kF32 = 2 };

__device__ __forceinline__ void store(void* out, long long idx, float y,
                                      float s, int act, int out_kind) {
  if (act == kLeaky) {
    y = y >= 0.f ? y : __fmul_rn(0.01f, y);
  } else if (act == kRelu) {
    y = fmaxf(y, 0.f);
  }
  if (out_kind == kInt8) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
    static_cast<int8_t*>(out)[idx] = (int8_t)(int)q;
  } else if (out_kind == kBf16) {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(out)[idx] = y;
  }
}

__global__ void __launch_bounds__(kThreads) transpose_conv2x_int8_kernel(
    const int* __restrict__ x,         // [B, H, W, CW] words of 4 channels
    const int* __restrict__ taps,      // [CW, 9, O] words
    const float* __restrict__ deq, const float* __restrict__ bias,
    const float* __restrict__ out_scale, void* __restrict__ out, int H,
    int W, int CW, int O, int n_col_tiles, int act, int out_kind) {
  __shared__ int xs[2][kTW + 1][kKW];
  __shared__ int ws[kKW][9][kTO];

  const int col_tile = blockIdx.x % n_col_tiles;
  const int bm = blockIdx.x / n_col_tiles;  // b * H + m
  const int m = bm % H;
  const int b = bm / H;
  const int n0 = col_tile * kTW;
  const int o0 = blockIdx.y * kTO;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c0 = (tid >> 5) * kCols;

  int acc[kCols][2][4];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[j][h][p] = 0;

  for (int k0 = 0; k0 < CW; k0 += kKW) {
    const int kn = min(kKW, CW - k0);
    for (int i = tid; i < 2 * (kTW + 1) * kKW; i += kThreads) {
      const int kw = i % kKW;
      const int col = (i / kKW) % (kTW + 1);
      const int r = i / (kKW * (kTW + 1));
      const int row = m + r;
      const int n = n0 + col;
      int v = 0;
      if (kw < kn && row < H && n < W) {
        v = x[(((long long)b * H + row) * W + n) * CW + k0 + kw];
      }
      xs[r][col][kw] = v;
    }
    for (int i = tid; i < kKW * 9 * kTO; i += kThreads) {
      const int o = i % kTO;
      const int t = (i / kTO) % 9;
      const int kw = i / (kTO * 9);
      int v = 0;
      if (kw < kn && o0 + o < O) {
        v = taps[((long long)(k0 + kw) * 9 + t) * O + o0 + o];
      }
      ws[kw][t][o] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int kw = 0; kw < kKW; ++kw) {
      int xa[kCols + 1], xb[kCols + 1];
#pragma unroll
      for (int j = 0; j <= kCols; ++j) {
        xa[j] = xs[0][c0 + j][kw];
        xb[j] = xs[1][c0 + j][kw];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int wt[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) wt[t] = ws[kw][t][lane + 32 * h];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc[j][h][0] = __dp4a(xa[j], wt[0], acc[j][h][0]);
          acc[j][h][1] = __dp4a(xa[j], wt[1], acc[j][h][1]);
          acc[j][h][1] = __dp4a(xa[j + 1], wt[2], acc[j][h][1]);
          acc[j][h][2] = __dp4a(xa[j], wt[3], acc[j][h][2]);
          acc[j][h][2] = __dp4a(xb[j], wt[4], acc[j][h][2]);
          acc[j][h][3] = __dp4a(xa[j], wt[5], acc[j][h][3]);
          acc[j][h][3] = __dp4a(xa[j + 1], wt[6], acc[j][h][3]);
          acc[j][h][3] = __dp4a(xb[j], wt[7], acc[j][h][3]);
          acc[j][h][3] = __dp4a(xb[j + 1], wt[8], acc[j][h][3]);
        }
      }
    }
    __syncthreads();
  }

  const int Ho = 2 * H, Wo = 2 * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = o0 + lane + 32 * h;
    if (o >= O) continue;
    const float d = deq[o], bb = bias[o], s = out_scale[o];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int n = n0 + c0 + j;
      if (n >= W) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int oy = 2 * m + (p >> 1);
        const int ox = 2 * n + (p & 1);
        const long long idx = (((long long)b * Ho + oy) * Wo + ox) * O + o;
        const float y = __fmaf_rn(__int2float_rn(acc[j][h][p]), d, bb);
        store(out, idx, y, s, act, out_kind);
      }
    }
  }
}

}  // namespace

// x [B, H, W, C] int8 with C % 4 == 0, 4-byte aligned; taps [C/4, 9, O]
// int32 words (4 input channels each, tap order of phase_tap_matrices);
// deq, bias, out_scale [O] f32; out [B, 2H, 2W, O] int8 (out_kind 0),
// bf16 (1) or f32 (2); act 0 none, 1 leaky 0.01, 2 relu.  All
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int tauv_transpose_conv2x_int8(const void* x, const void* taps,
                                          const void* deq, const void* bias,
                                          const void* out_scale, void* out,
                                          int B, int H, int W, int C, int O,
                                          int act, int out_kind, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_col_tiles = (W + kTW - 1) / kTW;
  const long long blocks_x = (long long)B * H * n_col_tiles;
  if (blocks_x > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks_x, (unsigned)((O + kTO - 1) / kTO));
  transpose_conv2x_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)taps, (const float*)deq, (const float*)bias,
      (const float*)out_scale, out, H, W, C / 4, O, n_col_tiles, act,
      out_kind);
  return (int)cudaGetLastError();
}
