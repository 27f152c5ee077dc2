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
//   ee = x[m,n] t0
//   eo = x[m,n] t1 + x[m,n+1] t2
//   oe = x[m,n] t3 + x[m+1,n] t4
//   oo = x[m,n] t5 + x[m,n+1] t6 + x[m+1,n] t7 + x[m+1,n+1] t8
// with row m+1 and column n+1 reading zero past the edge.  No dilation
// zero is multiplied.
//
// What bounds it on Hopper: operations.  At the served shapes (C = O =
// 256) each output needs 2.25 C multiply-adds and one store of 1 byte
// (int8 out), so the work is 2 * 9 * B * H * W * C * O operations
// against ~5 * B * H * W * C bytes: far above the card's ridge point.
// The bound is the tensor cores' int8 rate.  The design is an implicit
// GEMM for each phase on mma.sync m16n8k32 s8 (M = input pixels, N =
// output channels, K = C x the phase's taps), with no patch built:
//   - a block owns 64 output channels (blockIdx.y) and keeps all 9 taps
//     of them resident in shared memory, [9][64][C] bytes with K
//     contiguous (ops/transpose_conv.py:kernel_taps), loaded once: the
//     blocks are persistent (about one an SM), each walking M tiles;
//   - an M tile is kSeg = 80 input columns of one input row m (80 and
//     160, the served widths, split into whole tiles; 5 m16 fragments).
//     It needs rows m and m+1 and one halo column, all C channels: a
//     stage of 2 x 81 x C bytes, brought in with cp.async (zero-filled
//     past the edges) one tile ahead, two stages;
//   - in NHWC a tap shift moves whole pixels, so each lane's ldmatrix
//     row address for tap (dy, dx) is that of pixel (m+dy, n+dx) in the
//     staged tile: the four shifts are four addresses of one tile.  The
//     16-byte chunks of each pixel (and of each tap row) are XOR-swizzled
//     by its index, so the 8 rows an ldmatrix phase reads, 8 consecutive
//     pixels 256 bytes apart, hit 8 different bank groups;
//   - warp w owns output channels 8w..8w+7 of the block's 64, all 80
//     columns and all 4 phases: 5 x 4 accumulator fragments.  For each
//     32 bytes of K it loads the 9 taps' B fragments once and, for each
//     m16 fragment, the 4 shifted A fragments, then issues the 9 mmas;
//   - integer accumulation is exact, so any order gives the JAX
//     accumulator; the epilogue is __fmaf_rn(acc, deq, bias): one
//     rounding, as XLA contracts `acc * deq + bias` in the compiled JAX
//     graph (and torch.addcmul in the plain version), then leaky
//     (0.01 y) or relu, then rint (half to even, as jnp.round) of an
//     IEEE division and a clamp to [-127, 127], or __float2bfloat16_rn;
//   - the epilogue goes through shared memory: the block's outputs are
//     written into the stage just read ([phase][80][64 channels],
//     chunks swizzled), then stored as 16-byte vectors of contiguous
//     channels along each output row (f32 in two passes, one output row
//     each).  A ragged O (or one whose pixel rows are not 16-byte
//     multiples) is stored element by element; a ragged W is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 80;                // input columns an M tile
constexpr int kMT = kSeg / 16;          // m16 fragments an M tile
constexpr int kCols = kSeg + 1;         // staged columns, with the halo
constexpr int kTO = 8 * kWarps;         // output channels a block
constexpr int kEpiBytes = 40960;        // the largest epilogue pass
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block

enum Act { kNone = 0, kLeaky = 1, kRelu = 2 };
enum OutKind { kInt8 = 0, kBf16 = 1, kF32 = 2 };

// A stage: 2 input rows x 81 columns x C bytes, and room for the
// epilogue (kEpiBytes: 4 phases x 80 x 64 bf16, or 2 phases of f32).
__host__ __device__ __forceinline__ int stage_bytes(int C) {
  return 2 * kCols * C > kEpiBytes ? 2 * kCols * C : kEpiBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float activate(int acc, float d, float b, int act) {
  float y = __fmaf_rn(__int2float_rn(acc), d, b);
  if (act == kLeaky) {
    y = y >= 0.f ? y : __fmul_rn(0.01f, y);
  } else if (act == kRelu) {
    y = fmaxf(y, 0.f);
  }
  return y;
}

__device__ __forceinline__ int8_t requant(float y, float s) {
  return (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
}

template <int kOut>
__global__ void __launch_bounds__(kThreads, 1) transpose_conv2x_int8_kernel(
    const int8_t* __restrict__ x,       // [B, H, W, C]
    const int8_t* __restrict__ taps,    // [9, O, C]
    const float* __restrict__ deq, const float* __restrict__ bias,
    const float* __restrict__ out_scale, void* __restrict__ out, int H,
    int W, int C, int O, int n_seg, int n_tiles, int act) {
  constexpr int kEsz = kOut == kInt8 ? 1 : kOut == kBf16 ? 2 : 4;
  constexpr int kCS = kTO * kEsz / 16;          // 16-byte chunks of 64 channels
  constexpr int kPass = kOut == kF32 ? 2 : 4;   // phases an epilogue pass
  // bytes a phase in the epilogue; int8's 4 extra chunks put the two
  // phases of one output row in different bank groups
  constexpr int kPhase = (kSeg * kCS + (kCS == 4 ? 4 : 0)) * 16;
  static_assert(kPass * kPhase <= kEpiBytes, "epilogue exceeds a stage");

  extern __shared__ __align__(128) uint8_t smem[];
  const int stage = stage_bytes(C);
  const uint32_t ws = smem_u32(smem);                 // [9][64][C] taps
  uint8_t* stages = smem + 9 * kTO * C;              // 2 stages
  const uint32_t st0 = smem_u32(stages);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = blockIdx.y * kTO;
  const int chunks = C >> 4;                   // 16-byte chunks a pixel
  const int low = chunks & -chunks;            // XOR swizzle over
  const int mask = (low < 8 ? low : 8) - 1;    // min(8, 2^k | chunks) chunks

  int tile = blockIdx.x;
  if (tile >= n_tiles) return;

  for (int i = tid; i < 9 * kTO * chunks; i += kThreads) {
    const int ck = i % chunks, row = i / chunks;   // row = t * 64 + o
    const int o = o0 + row % kTO, t = row / kTO;
    const bool ok = o < O;
    const int8_t* src = ok ? taps + ((long long)t * O + o) * C + ck * 16 : taps;
    cp_async16(ws + row * C + ((ck ^ (row & mask)) << 4), src, ok);
  }

  auto load_tile = [&](int tl, int s) {
    const int seg = tl % n_seg, bm = tl / n_seg;
    const int m = bm % H, b = bm / H;
    const int n0 = seg * kSeg;
    const uint32_t dst = st0 + s * stage;
    for (int i = tid; i < 2 * kCols * chunks; i += kThreads) {
      const int ck = i % chunks, q = i / chunks;   // q = r * 81 + col
      const int r = q / kCols, col = q - r * kCols;
      const int row = m + r, n = n0 + col;
      const bool ok = row < H && n < W;
      const int8_t* src =
          ok ? x + (((long long)b * H + row) * W + n) * C + ck * 16 : x;
      cp_async16(dst + q * C + ((ck ^ (q & mask)) << 4), src, ok);
    }
  };
  load_tile(tile, 0);
  cp_async_commit();

  // The accumulator fragment of lane (g, t4): pixels 16j + g and + 8,
  // channels 8 warp + 2 t4 and + 1.
  const int g = lane >> 2, t4 = lane & 3;
  const int ch = 8 * warp + 2 * t4;
  float dq[2], bi[2], sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = o0 + ch + h;
    dq[h] = o < O ? deq[o] : 0.f;
    bi[h] = o < O ? bias[o] : 0.f;
    sc[h] = o < O ? out_scale[o] : 1.f;
  }

  // ldmatrix row addresses.  A (x4, a 16 x 32-byte fragment): lane l
  // gives pixel l & 15 of the fragment at K half l >> 4; shift s = 2 dy +
  // dx.  B (x2, 8 channels x 32 bytes): lanes 0-15 give channel l & 7 at
  // K half (l >> 3) & 1.  A fragment j adds 16 pixels, which keeps the
  // swizzle (mask < 16).
  int a_base[4], a_sw[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int q = (s >> 1) * kCols + (s & 1) + (lane & 15);
    a_base[s] = q * C;
    a_sw[s] = q & mask;
  }
  const int a_half = lane >> 4;
  const int b_row = 8 * warp + (lane & 7);
  const uint32_t b_base = ws + b_row * C;
  const int b_sw = b_row & mask, b_half = (lane >> 3) & 1;
  const bool vec = (O * kEsz) % 16 == 0;

  for (int it = 0; tile < n_tiles; ++it) {
    const int next = tile + gridDim.x;
    const int s = it & 1;
    if (next < n_tiles) {
      load_tile(next, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    int acc[kMT][4][4];
#pragma unroll
    for (int j = 0; j < kMT; ++j)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][p][i] = 0;

    const uint32_t st = st0 + s * stage;
#pragma unroll 1
    for (int ks = 0; ks < chunks / 2; ++ks) {
      uint32_t bf[9][2];
      const uint32_t b_off = b_base + (((2 * ks + b_half) ^ b_sw) << 4);
#pragma unroll
      for (int t = 0; t < 9; ++t) ldsm_x2(bf[t], b_off + t * kTO * C);
      uint32_t a_off[4];
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4)
        a_off[s4] = st + a_base[s4] + (((2 * ks + a_half) ^ a_sw[s4]) << 4);
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        uint32_t a[4][4];
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) ldsm_x4(a[s4], a_off[s4] + j * 16 * C);
        mma_s8(acc[j][0], a[0], bf[0]);   // ee
        mma_s8(acc[j][1], a[0], bf[1]);   // eo
        mma_s8(acc[j][1], a[1], bf[2]);
        mma_s8(acc[j][2], a[0], bf[3]);   // oe
        mma_s8(acc[j][2], a[2], bf[4]);
        mma_s8(acc[j][3], a[0], bf[5]);   // oo
        mma_s8(acc[j][3], a[1], bf[6]);
        mma_s8(acc[j][3], a[2], bf[7]);
        mma_s8(acc[j][3], a[3], bf[8]);
      }
    }
    __syncthreads();   // every warp is done reading stage s

    const int seg = tile % n_seg, bm = tile / n_seg;
    const int m = bm % H, b = bm / H;
    const int n0 = seg * kSeg;
    uint8_t* epi = stages + s * stage;
#pragma unroll
    for (int pass = 0; pass < 4 / kPass; ++pass) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p / kPass != pass) continue;
        uint8_t* ph = epi + (p - pass * kPass) * kPhase;
#pragma unroll
        for (int j = 0; j < kMT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = 16 * j + g + 8 * h;
            const int sw = kCS >= 8 ? (n & 7) : ((n >> 1) & 3);
            const int byte = ch * kEsz;
            uint8_t* dst = ph + n * kCS * 16 + (((byte >> 4) ^ sw) << 4) + (byte & 15);
            const float y0 = activate(acc[j][p][2 * h], dq[0], bi[0], act);
            const float y1 = activate(acc[j][p][2 * h + 1], dq[1], bi[1], act);
            if constexpr (kOut == kInt8) {
              *reinterpret_cast<uint16_t*>(dst) =
                  (uint16_t)(uint8_t)requant(y0, sc[0]) |
                  (uint16_t)((uint16_t)(uint8_t)requant(y1, sc[1]) << 8);
            } else if constexpr (kOut == kBf16) {
              __nv_bfloat162 v;
              v.x = __float2bfloat16_rn(y0);
              v.y = __float2bfloat16_rn(y1);
              *reinterpret_cast<__nv_bfloat162*>(dst) = v;
            } else {
              *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
            }
          }
      }
      __syncthreads();
      // Output rows 2m + py of this pass, columns 2 n0 .. 2 n0 + 159,
      // channels o0 .. o0 + 63: 16-byte chunks, the chunk index fastest.
      constexpr int kRows = kPass / 2;
      for (int i = tid; i < kRows * 2 * kSeg * kCS; i += kThreads) {
        const int c = i % kCS, ox = (i / kCS) % (2 * kSeg);
        const int pr = i / (kCS * 2 * kSeg);
        const int n = ox >> 1, px = ox & 1;
        if (n0 + n >= W) continue;
        const int oc = o0 + c * (16 / kEsz);
        if (oc >= O) continue;
        const int sw = kCS >= 8 ? (n & 7) : ((n >> 1) & 3);
        const uint4 v = *reinterpret_cast<const uint4*>(
            epi + (2 * pr + px) * kPhase + n * kCS * 16 + ((c ^ sw) << 4));
        const int oy = 2 * m + pass * kRows + pr;
        const long long idx =
            (((long long)b * 2 * H + oy) * 2 * W + 2 * (n0 + n) + px) * O + oc;
        uint8_t* dst = static_cast<uint8_t*>(out) + idx * kEsz;
        if (vec && oc + 16 / kEsz <= O) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
          for (int e = 0; e < 16 / kEsz && oc + e < O; ++e)
            for (int k = 0; k < kEsz; ++k) dst[e * kEsz + k] = bytes[e * kEsz + k];
        }
      }
      __syncthreads();   // before the stage is written again
    }
    tile = next;
  }
}

template <int kOut>
int launch(const void* x, const void* taps, const void* deq, const void* bias,
           const void* out_scale, void* out, int H, int W, int C, int O,
           int n_seg, int n_tiles, int blocks, int n_o, int smem, int act,
           cudaStream_t stream) {
  auto kernel = transpose_conv2x_int8_kernel<kOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(blocks, n_o), kThreads, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)taps, (const float*)deq,
      (const float*)bias, (const float*)out_scale, out, H, W, C, O, n_seg,
      n_tiles, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] int8, C a multiple of 32 and at most 256 (the resident
// taps and two stages must fit a block's shared memory), 16-byte
// aligned; taps [9, O, C] int8 (tap order of phase_tap_matrices, K
// contiguous), 16-byte aligned; deq, bias, out_scale [O] f32; out
// [B, 2H, 2W, O] int8 (out_kind 0), bf16 (1) or f32 (2), 16-byte
// aligned; act 0 none, 1 leaky 0.01, 2 relu.  All contiguous.  Returns
// cudaErrorInvalidValue for a C it does not take, else the error of
// cudaFuncSetAttribute or cudaGetLastError() after the launch.
extern "C" int tauv_transpose_conv2x_int8(const void* x, const void* taps,
                                          const void* deq, const void* bias,
                                          const void* out_scale, void* out,
                                          int B, int H, int W, int C, int O,
                                          int act, int out_kind, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || C % 32 != 0) return (int)cudaErrorInvalidValue;
  const long long smem = 9LL * kTO * C + 2LL * stage_bytes(C);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n_seg = (W + kSeg - 1) / kSeg;
  const long long n_tiles = (long long)B * H * n_seg;
  const int n_o = (O + kTO - 1) / kTO;
  if (n_tiles > INT_MAX || n_o > 65535) return (int)cudaErrorInvalidConfiguration;
  // Persistent blocks: about one an SM over the n_o channel tiles.
  long long blocks = sms / n_o > 1 ? sms / n_o : 1;
  if (blocks > n_tiles) blocks = n_tiles;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (out_kind) {
    case kInt8:
      return launch<kInt8>(x, taps, deq, bias, out_scale, out, H, W, C, O,
                           n_seg, (int)n_tiles, (int)blocks, n_o, (int)smem,
                           act, s);
    case kBf16:
      return launch<kBf16>(x, taps, deq, bias, out_scale, out, H, W, C, O,
                           n_seg, (int)n_tiles, (int)blocks, n_o, (int)smem,
                           act, s);
    case kF32:
      return launch<kF32>(x, taps, deq, bias, out_scale, out, H, W, C, O,
                          n_seg, (int)n_tiles, (int)blocks, n_o, (int)smem,
                          act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
