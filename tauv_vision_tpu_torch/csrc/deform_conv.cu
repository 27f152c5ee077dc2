// Modulated deformable conv v2 (DCNv2), 3x3, stride 1, padding 1,
// dilation 1: the 16 IDA blocks of the DCN-IDA CenterNet.
//
// Replaces tauv_vision_tpu/ops/pallas/deform_conv.py:
// deform_conv2d_pallas (body _dcn_kernel), which samples with a static
// window of hat weights: a corner whose integer shift from the tap's base
// lies outside [lo, hi] = [-ceil(R), floor(R) + 1] adds zero.  This
// kernel samples directly: each bilinear corner outside the map reads
// zero, the mask multiplies the sample, and a corner outside [lo, hi]
// reads zero too when the caller passes a window (lo != kNoWindow);
// without one the offsets are unbounded (torchvision's semantics).
//
// Two entry points from one template:
// - tauv_deform_conv_f32: f32 in and out; without a window the gather
//   formulation of ops/deform_conv.deform_conv2d (bilinear weights from
//   the sample position, x mask, folded into 4 fused multiply-adds a
//   sample), with one the bf16 entry point's hats and rounding order in
//   f32 (the plain version's windowed f32 formulation);
// - tauv_deform_conv_bf16: x, weight and mask bf16, offsets f32, rounding
//   as the Pallas body does: hat weights from the offset, each row's
//   column pair summed first, then the rows, then x mask, every step an
//   f32 op rounded on its own (no contraction); the sample rounded to
//   bf16, multiplied by the bf16 weight with f32 accumulation, + f32
//   bias, rounded to bf16.
//
// What bounds it on Hopper: the products, 2 x 9 C O operations an output
// pixel (12.56 GFLOP a 640x360 frame over the 16 calls), on the tensor
// cores, and the bilinear gather that feeds them, 4 reads from L1 / L2 for
// each (pixel, tap, channel).  The design is an implicit GEMM, M = output
// pixels (flattened over the batch), N = output channels, K = 9 taps x C:
//
// - a block owns BM = 64 or 128 consecutive pixels against all N = O of
//   the call (O padded to BN = 64, 128 or 256 with zero weights), so each
//   sample is gathered once;
// - K runs as (tap, 64-byte channel chunk) steps: 32 bf16 or 16 f32
//   channels.  For each tap, each thread computes the 4 corner offsets
//   and weights of its pixels once, in registers (the next tap's offsets
//   and mask are loaded a tap ahead);
// - the net's NCHW input is first transposed to NHWC by a tiled kernel
//   of the same entry point (32 channels x 64 pixels through shared
//   memory), so that a pixel's channels are contiguous;
// - each step, a thread reads its pixel's 4 corners as 16-byte vectors
//   over channels (x is NHWC), blends them in f32 and stores the sample
//   in the operand type into the A tile [BM rows x 64 bytes]; the weights
//   ([9][BN][C], K contiguous, laid out once per weight version by
//   ops/deform_conv.kernel_weights) stream into the B tile [BN x 64
//   bytes] with cp.async.  Both tiles XOR-swizzle their 16-byte chunks by
//   (row >> 1) & 3, so ldmatrix's 8 rows and the gather's stores hit 8
//   bank groups;
// - two stages: the gather loads and the weight copy of step k+1 are in
//   flight while the warps run step k's products; one barrier a step;
// - products: bf16 on mma.sync.m16n8k16 (f32 accumulate); f32 on
//   mma.sync.m16n8k8 TF32 with the 3xTF32 split, a = a_hi + a_lo and b
//   likewise, acc += a_lo b_hi + a_hi b_lo + a_hi b_hi, which keeps f32
//   accuracy (the kernel's own arithmetic: cuDNN's TF32 stays off); the
//   split masks and subtracts, with no conversion instruction;
// - 8 warps, each a 32-pixel x BN / (8 / (BM / 32)) output tile;
// - a grid with fewer pixel tiles than the SMs hold blocks at once (at
//   batch 8: 12x20, and 23x40 at O <= 128) splits K over blockIdx.y
//   (ops/deform_conv.plan); each split writes its f32 partial sums, and a
//   second kernel adds them in split order, + bias: deterministic, no
//   atomics;
// - epilogue: + bias, rounded to the output type, staged through shared
//   memory and stored NCHW as vectors of 4 pixels (16 bytes of f32, 8 of
//   bf16) where H W is a multiple of 4 (every served call), element by
//   element elsewhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;
constexpr int kRow = 64;   // bytes a tile row: one K step
constexpr int kNoWindow = -2147483647 - 1;   // lo of "no window": INT_MIN

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `ck` of row `row` in a tile of 64-byte rows.
__device__ __forceinline__ int swz(int row, int ck) {
  return row * kRow + ((ck ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo exactly: hi keeps v's sign, exponent and top 10 mantissa
// bits (a TF32 value), lo = v - hi is exact in f32.  The tensor cores
// read a TF32 operand's top 19 bits, so lo enters its products
// truncated to 11 significant bits: a relative error of at most 2^-21 of
// v in a_hi b_lo and a_lo b_hi, and a_lo b_lo (2^-22) is dropped.  No
// conversion instruction: one logic op and one subtraction.
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = v & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(v), __uint_as_float(hi)));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }

// The 4 bilinear corners of one (pixel, tap): element offsets into x
// (-1 outside the map or the window, read as zero) and the weights.  The
// hats (bf16, and f32 with a window): wx0, wx1, wy0, wy1, mask (the
// Pallas body's); f32 without a window: the 4 corner weights x mask (the
// gather formulation), w[4] unused.
struct Corners {
  int idx[4];
  float w[5];
};

// Corner (row r, column c) of the top-left corner's cell and its three
// neighbours: element offsets of the valid ones, -1 for those outside the
// map.  ``bhw`` is the pixel's image times H W.
__device__ __forceinline__ void corner_offsets(Corners& c, int r, int col, int bhw, int H,
                                               int W, int C) {
  const bool r0 = (unsigned)r < (unsigned)H, r1 = (unsigned)(r + 1) < (unsigned)H;
  const bool c0 = (unsigned)col < (unsigned)W, c1 = (unsigned)(col + 1) < (unsigned)W;
  const int base = (bhw + r * W + col) * C;
  c.idx[0] = r0 && c0 ? base : -1;
  c.idx[1] = r0 && c1 ? base + C : -1;
  c.idx[2] = r1 && c0 ? base + W * C : -1;
  c.idx[3] = r1 && c1 ? base + W * C + C : -1;
}

// floor(v) as an int, clamped far outside any map first, so that any
// finite offset converts safely.
__device__ __forceinline__ int floor_int(float f) {
  return (int)fminf(fmaxf(f, -65536.f), 65536.f);
}

template <bool kBf16>
__device__ __forceinline__ void corners(Corners& c, bool valid, int bhw, int oy, int ox,
                                        int ky, int kx, float dy, float dx, float m,
                                        int H, int W, int C, int lo, int hi) {
  if (!valid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c.idx[k] = -1;
#pragma unroll
    for (int k = 0; k < 5; ++k) c.w[k] = 0.f;
    return;
  }
  if (kBf16 || lo != kNoWindow) {
    // hat(s) = max(0, 1 - |d - s|) at the integer shifts s = floor(d)
    // and floor(d) + 1, as _dcn_kernel's "full" variant computes it.
    const float fy = floorf(dy), fx = floorf(dx);
    c.w[0] = __fsub_rn(1.f, __fsub_rn(dx, fx));
    c.w[1] = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(dx, __fadd_rn(fx, 1.f)))));
    c.w[2] = __fsub_rn(1.f, __fsub_rn(dy, fy));
    c.w[3] = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(dy, __fadd_rn(fy, 1.f)))));
    c.w[4] = m;
    const int sy = floor_int(fy), sx = floor_int(fx);
    corner_offsets(c, oy - 1 + ky + sy, ox - 1 + kx + sx, bhw, H, W, C);
    if (lo != kNoWindow) {
      // Shifts s and s + 1 of each axis from the tap's base, in [lo, hi].
      const bool y0 = sy >= lo && sy <= hi, y1 = sy + 1 >= lo && sy + 1 <= hi;
      const bool x0 = sx >= lo && sx <= hi, x1 = sx + 1 >= lo && sx + 1 <= hi;
      if (!(y0 && x0)) c.idx[0] = -1;
      if (!(y0 && x1)) c.idx[1] = -1;
      if (!(y1 && x0)) c.idx[2] = -1;
      if (!(y1 && x1)) c.idx[3] = -1;
    }
  } else {
    const float y = (float)(oy - 1 + ky) + dy;
    const float x = (float)(ox - 1 + kx) + dx;
    const float y0 = floorf(y), x0 = floorf(x);
    const float ly = y - y0, lx = x - x0;
    const float hy = 1.f - ly, hx = 1.f - lx;
    const float cw[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
    corner_offsets(c, floor_int(y0), floor_int(x0), bhw, H, W, C);
#pragma unroll
    for (int k = 0; k < 4; ++k) c.w[k] = c.idx[k] >= 0 ? cw[k] * m : 0.f;
    c.w[4] = 0.f;
  }
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float hat_sample(const float (&w)[5], float a00, float a01,
                                            float a10, float a11) {
  const float t0 = __fadd_rn(__fmul_rn(w[0], a00), __fmul_rn(w[1], a01));
  const float t1 = __fadd_rn(__fmul_rn(w[0], a10), __fmul_rn(w[1], a11));
  return __fmul_rn(__fadd_rn(__fmul_rn(w[2], t0), __fmul_rn(w[3], t1)), w[4]);
}

// 8 bf16 channels of the 4 corners -> 8 bf16 samples (always the hats).
__device__ __forceinline__ uint4 sample_vec(const uint4 (&v)[4], const float (&w)[5], bool,
                                            __nv_bfloat16*) {
  const uint32_t* c0 = reinterpret_cast<const uint32_t*>(&v[0]);
  const uint32_t* c1 = reinterpret_cast<const uint32_t*>(&v[1]);
  const uint32_t* c2 = reinterpret_cast<const uint32_t*>(&v[2]);
  const uint32_t* c3 = reinterpret_cast<const uint32_t*>(&v[3]);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float lo = hat_sample(w, lo_bf16(c0[p]), lo_bf16(c1[p]), lo_bf16(c2[p]), lo_bf16(c3[p]));
    const float hi = hat_sample(w, hi_bf16(c0[p]), hi_bf16(c1[p]), hi_bf16(c2[p]), hi_bf16(c3[p]));
    const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
    o[p] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  return out;
}

// 4 f32 channels of the 4 corners -> 4 f32 samples: the hats where
// ``hat`` (a window), else the 4 corner weights.
__device__ __forceinline__ uint4 sample_vec(const uint4 (&v)[4], const float (&w)[5], bool hat,
                                            float*) {
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
  const uint32_t* c0 = reinterpret_cast<const uint32_t*>(&v[0]);
  const uint32_t* c1 = reinterpret_cast<const uint32_t*>(&v[1]);
  const uint32_t* c2 = reinterpret_cast<const uint32_t*>(&v[2]);
  const uint32_t* c3 = reinterpret_cast<const uint32_t*>(&v[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a00 = __uint_as_float(c0[e]), a01 = __uint_as_float(c1[e]);
    const float a10 = __uint_as_float(c2[e]), a11 = __uint_as_float(c3[e]);
    o[e] = __float_as_uint(hat ? hat_sample(w, a00, a01, a10, a11)
                               : fmaf(w[3], a11, fmaf(w[2], a10, fmaf(w[1], a01, fmaf(w[0], a00, 0.f)))));
  }
  return out;
}

// Shared memory a block: two stages of the A and B tiles, or the
// epilogue's [BN][BM + 4] f32 staging, whichever is larger.
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  return 2 * (bm + bn) * kRow > bn * (bm + 4) * 4 ? 2 * (bm + bn) * kRow
                                                  : bn * (bm + 4) * 4;
}

// Two blocks an SM where BN <= 128 (at most 128 registers a thread); one
// where BN = 256, whose 64 accumulators a thread would spill at 128.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, BN <= 128 ? 2 : 1) deform_conv_kernel(
    const T* __restrict__ x,          // [B, H, W, C]
    const float* __restrict__ offset,  // [B, 18, H, W]
    const T* __restrict__ mask,        // [B, 9, H, W] or null
    const T* __restrict__ taps,        // [9, BN, C]
    const float* __restrict__ bias,    // [O] or null
    T* __restrict__ out,               // [B, O, H, W]
    float* __restrict__ partial,       // [S, B, O, H, W] when split, else null
    int B, int C, int H, int W, int O, int per_split, int lo, int hi) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kWarpsM = BM / 32;
  constexpr int kWarpsN = (kThreads / 32) / kWarpsM;
  constexpr int kWN = BN / kWarpsN;        // output channels a warp
  constexpr int kNT = kWN / 8;             // n8 fragments a warp
  constexpr int kRJ = BM / 64;             // pixels a thread gathers
  constexpr int kVec = 16 / sizeof(T);     // channels in 16 bytes
  constexpr int kChunkC = kRow / sizeof(T);
  constexpr int kStageA = BM * kRow, kStage = (BM + BN) * kRow;
  static_assert(kNT % 2 == 0, "n fragments come in ldmatrix.x4 pairs");

  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * BM;
  const int chunks = C / kChunkC;          // K steps a tap
  const int n_iter = kTaps * chunks;
  const int it0 = blockIdx.y * per_split;
  const int it1 = min(it0 + per_split, n_iter);

  // ---- the gather's share of this thread: pixels r + 64 j, chunk q ----
  const int q = tid & 3, r = tid >> 2;
  int pbhw[kRJ], poy[kRJ], pox[kRJ];
  const float* poff[kRJ];   // the pixel's tap-0 dy; dx is HW further, tap t 2 t HW
  const T* pmask[kRJ];      // the pixel's tap-0 mask, or null
  bool pval[kRJ];
#pragma unroll
  for (int j = 0; j < kRJ; ++j) {
    const int m = m0 + r + 64 * j;
    pval[j] = m < M;
    const int mm = pval[j] ? m : 0;
    const int b = mm / HW, hw = mm - b * HW;
    pbhw[j] = b * HW;
    poy[j] = hw / W;
    pox[j] = hw - poy[j] * W;
    poff[j] = offset + (size_t)b * 2 * kTaps * HW + hw;
    pmask[j] = mask ? mask + (size_t)b * kTaps * HW + hw : nullptr;
  }
  float ndy[kRJ], ndx[kRJ], nm[kRJ];   // offsets and mask of the next tap
  auto load_offsets = [&](int tap) {
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      ndy[j] = pval[j] ? __ldg(poff[j] + 2 * tap * HW) : 0.f;
      ndx[j] = pval[j] ? __ldg(poff[j] + (2 * tap + 1) * HW) : 0.f;
      nm[j] = pval[j] && pmask[j] ? to_f32(pmask[j][tap * HW]) : 1.f;
    }
  };
  Corners cor[kRJ];
  uint4 vals[kRJ][4];

  // K step `it` is (tap, chunk); the gather and the weight copy each keep
  // their next step's (tap, chunk) and step them without a division.
  int g_tap = it0 / chunks, g_chunk = it0 - g_tap * chunks;
  auto gather_load = [&](bool new_tap) {
    if (new_tap) {
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
        corners<kBf16>(cor[j], pval[j], pbhw[j], poy[j], pox[j], g_tap / 3, g_tap % 3,
                       ndy[j], ndx[j], nm[j], H, W, C, lo, hi);
      if (g_tap + 1 < kTaps) load_offsets(g_tap + 1);
    }
    const T* xc = x + g_chunk * kChunkC + q * kVec;
#pragma unroll
    for (int j = 0; j < kRJ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        vals[j][k] = cor[j].idx[k] >= 0
                         ? __ldg(reinterpret_cast<const uint4*>(xc + cor[j].idx[k]))
                         : make_uint4(0, 0, 0, 0);
    if (++g_chunk == chunks) {
      g_chunk = 0;
      ++g_tap;
    }
  };
  auto gather_store = [&](int stage) {
    uint8_t* a = smem + stage * kStage;
#pragma unroll
    for (int j = 0; j < kRJ; ++j)
      *reinterpret_cast<uint4*>(a + swz(r + 64 * j, q)) =
          sample_vec(vals[j], cor[j].w, lo != kNoWindow, static_cast<T*>(nullptr));
  };
  // The weight copy: BN rows x 4 chunks of 16 bytes, kBR of them a thread,
  // at offsets fixed for the whole loop.
  constexpr int kBR = BN * 4 / kThreads;
  static_assert(kBR * kThreads == BN * 4, "BN is 64, 128 or 256");
  int b_dst[kBR], b_src[kBR];
#pragma unroll
  for (int e = 0; e < kBR; ++e) {
    const int i = tid + e * kThreads, n = i >> 2, ck = i & 3;
    b_dst[e] = kStageA + swz(n, ck);
    b_src[e] = n * C + ck * kVec;
  }
  const T* b_next = taps + (size_t)g_tap * BN * C + g_chunk * kChunkC;
  int b_chunk = g_chunk;
  auto load_b = [&](int stage) {
    const uint32_t bt = s0 + stage * kStage;
#pragma unroll
    for (int e = 0; e < kBR; ++e) cp_async16(bt + b_dst[e], b_next + b_src[e]);
    // the next step: the next chunk, or the next tap's first
    b_next += kChunkC;
    if (++b_chunk == chunks) {
      b_chunk = 0;
      b_next += (size_t)(BN - 1) * C;
    }
  };

  // ---- the products: warp (wm, wn) owns pixels 32 wm.., channels kWN wn.. ----
  const int wm0 = (warp / kWarpsN) * 32, wn0 = (warp % kWarpsN) * kWN;
  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix rows: A lane l -> pixel l & 15 at chunk + (l >> 4); B lane l
  // -> channel (l & 7) + 8 (l >> 4) at chunk + ((l >> 3) & 1).
  const int a_row = wm0 + (lane & 15), a_ck = lane >> 4;
  const int b_row = wn0 + (lane & 7) + ((lane >> 4) << 3), b_ck = (lane >> 3) & 1;

  auto products = [&](int stage) {
    const uint32_t at = s0 + stage * kStage, bt = at + kStageA;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], at + swz(a_row + 16 * mt, 2 * ks + a_ck));
      if constexpr (kBf16) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, bt + swz(b_row + 16 * np, 2 * ks + b_ck));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      } else {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(af[mt][e], ah[mt][e], al[mt][e]);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bf[4], bh[4], bl[4];
          ldsm_x4(bf, bt + swz(b_row + 16 * np, 2 * ks + b_ck));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(bf[e], bh[e], bl[e]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float (&d)[4] = acc[mt][2 * np + h];
              mma_tf32(d, al[mt], bh[2 * h], bh[2 * h + 1]);
              mma_tf32(d, ah[mt], bl[2 * h], bl[2 * h + 1]);
              mma_tf32(d, ah[mt], bh[2 * h], bh[2 * h + 1]);
            }
        }
      }
    }
  };

  // ---- the pipeline: step it's products overlap step it+1's loads ----
  if (it0 < it1) {
    load_offsets(g_tap);
    gather_load(true);
    load_b(0);
    cp_async_commit();
    gather_store(0);
  }
  for (int it = it0; it < it1; ++it) {
    const int s = (it - it0) & 1;
    cp_async_wait_all();
    __syncthreads();
    const bool more = it + 1 < it1;
    if (more) {
      load_b(s ^ 1);
      cp_async_commit();
      gather_load(g_chunk == 0);
    }
    products(s);
    if (more) gather_store(s ^ 1);
  }
  __syncthreads();   // every warp's products done: the stages become the epilogue's

  // ---- epilogue: [BN][BM + 4] f32 in shared memory, then NCHW stores ----
  constexpr int kLd = BM + 4;
  float* st = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int px = wm0 + 16 * mt + g + 8 * (e >> 1);
        const int o = wn0 + 8 * nt + 2 * t4 + (e & 1);
        st[o * kLd + px] = acc[mt][nt][e];
      }
  __syncthreads();

  const bool split = partial != nullptr;
  float* pdst = split ? partial + (size_t)blockIdx.y * M * O : nullptr;
  constexpr int kV = 4;                     // pixels a vector: 4 f32 or 4 bf16
  const bool vec = HW % kV == 0;
  for (int i = tid; i < BN * (BM / kV); i += kThreads) {
    const int o = i / (BM / kV), pv = (i - o * (BM / kV)) * kV;
    if (o >= O) continue;
    const float bo = (split || bias == nullptr) ? 0.f : bias[o];
    const float* srow = st + o * kLd + pv;
    const int m = m0 + pv;
    if (vec && m < M) {
      // HW % 4 == 0: the 4 pixels lie in one image, 16- (8-) byte aligned.
      const int b = m / HW, hw = m - b * HW;
      const size_t at = ((size_t)b * O + o) * HW + hw;
      const float4 v = *reinterpret_cast<const float4*>(srow);
      if (split) {
        *reinterpret_cast<float4*>(pdst + at) = v;
      } else {
        T e[4];
        from_f32(e[0], v.x + bo);
        from_f32(e[1], v.y + bo);
        from_f32(e[2], v.z + bo);
        from_f32(e[3], v.w + bo);
        if constexpr (kBf16) {
          *reinterpret_cast<uint2*>(out + at) = *reinterpret_cast<const uint2*>(e);
        } else {
          *reinterpret_cast<float4*>(out + at) = *reinterpret_cast<const float4*>(e);
        }
      }
    } else {
      for (int e = 0; e < kV; ++e) {
        const int mm = m + e;
        if (mm >= M) break;
        const int b = mm / HW, hw = mm - b * HW;
        const size_t at = ((size_t)b * O + o) * HW + hw;
        if (split) {
          pdst[at] = srow[e];
        } else {
          from_f32(out[at], srow[e] + bo);
        }
      }
    }
  }
}

// out[i] = sum over splits s = 0.. of partial[s][i] (in that order), + bias.
template <typename T>
__global__ void deform_conv_reduce(const float* __restrict__ partial,
                                   const float* __restrict__ bias, T* __restrict__ out,
                                   int n, int splits, int O, int HW) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = partial[i];
  for (int s = 1; s < splits; ++s) v += partial[(size_t)s * n + i];
  if (bias) v += bias[(i / HW) % O];
  from_f32(out[i], v);
}

// x [B, C, HW] -> [B, HW, C]: a block moves 32 channels x 64 pixels
// through shared memory, reading 64 pixels of a channel and writing 32
// channels of a pixel, each a contiguous run.
template <typename T>
__global__ void __launch_bounds__(kThreads) nchw_to_nhwc(const T* __restrict__ x,
                                                         T* __restrict__ y, int C, int HW) {
  __shared__ T tile[32][65];
  const int b = blockIdx.z, c0 = blockIdx.y * 32, p0 = blockIdx.x * 64;
  const T* xb = x + (size_t)b * C * HW;
  T* yb = y + (size_t)b * HW * C;
  for (int i = threadIdx.x; i < 32 * 64; i += kThreads) {
    const int c = i >> 6, p = i & 63;
    if (p0 + p < HW) tile[c][p] = xb[(size_t)(c0 + c) * HW + p0 + p];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * 64; i += kThreads) {
    const int p = i >> 5, c = i & 31;
    if (p0 + p < HW) yb[(size_t)(p0 + p) * C + c0 + c] = tile[c][p];
  }
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* x_nchw, const void* x, const void* offset, const void* mask,
                   const void* taps, const void* bias, void* out, void* partial, int B, int C,
                   int H, int W, int O, int split, int lo, int hi, cudaStream_t stream) {
  constexpr int kChunkC = kRow / sizeof(T);
  constexpr int bytes = smem_bytes(BM, BN);
  static bool attr_set = false;   // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(deform_conv_kernel<T, BM, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 tgrid((H * W + 63) / 64, C / 32, B);
  nchw_to_nhwc<T><<<tgrid, kThreads, 0, stream>>>((const T*)x_nchw, (T*)x, C, H * W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_iter = kTaps * (C / kChunkC);
  const int per_split = (n_iter + split - 1) / split;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, split);
  deform_conv_kernel<T, BM, BN><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)offset, (const T*)mask, (const T*)taps, (const float*)bias,
      (T*)out, split > 1 ? (float*)partial : nullptr, B, C, H, W, O, per_split, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const int n = M * O;
  deform_conv_reduce<T><<<(n + 255) / 256, 256, 0, stream>>>(
      (const float*)partial, (const float*)bias, (T*)out, n, split, O, H * W);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x_nchw, const void* x, const void* offset, const void* mask,
             const void* taps, const void* bias, void* out, void* partial, int B, int C, int H,
             int W, int O, int bm, int bn, int split, int lo, int hi, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!x_nchw || !x || C % 32 || O % 8 || O > bn || split < 1 ||
      (split > 1 && partial == nullptr) || (lo != kNoWindow && lo > hi))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define TAUV_DCN_TILE(BM_, BN_)                                                         \
  if (bm == BM_ && bn == BN_)                                                           \
    return (int)launch<T, BM_, BN_>(x_nchw, x, offset, mask, taps, bias, out, partial, B, \
                                    C, H, W, O, split, lo, hi, s);
  TAUV_DCN_TILE(64, 256)
  TAUV_DCN_TILE(64, 128)
  TAUV_DCN_TILE(64, 64)
  TAUV_DCN_TILE(128, 64)
#undef TAUV_DCN_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_nchw [B, C, H, W], the input; x [B, H, W, C], scratch that the entry
// point fills with x_nchw's NHWC copy (a transpose kernel ahead of the
// DCN), which the DCN kernel reads.  offset
// [B, 18, H, W] f32 ((dy, dx) per tap, taps row-major), mask [B, 9, H, W]
// or null, taps [9, bn, C] (the weight [O, C, 3, 3] as
// ops/deform_conv.kernel_weights lays it out, rows O..bn-1 zero), bias
// [O] f32 or null, out [B, O, H, W]; x, mask, taps and out in the entry
// point's type, all contiguous, x and taps 16-byte aligned.  (bm, bn) in
// {(64, 256), (64, 128), (64, 64), (128, 64)}: the block's pixel and
// output-channel tile.  split > 1 splits K over that many blocks a pixel
// tile, with partial a [split, B, O, H, W] f32 scratch.  C a multiple of
// 32, O a multiple of 8 and at most bn.  [lo, hi]: the window of integer
// corner shifts from a tap's base that are read (ops/deform_conv.window),
// or lo = INT_MIN for none.  Returns cudaGetLastError() after the
// launches.
extern "C" int tauv_deform_conv_f32(const void* x_nchw, const void* x, const void* offset,
                                    const void* mask, const void* taps, const void* bias,
                                    void* out, void* partial, int B, int C, int H, int W,
                                    int O, int bm, int bn, int split, int lo, int hi,
                                    int device, void* stream) {
  return dispatch<float>(x_nchw, x, offset, mask, taps, bias, out, partial, B, C, H, W, O,
                         bm, bn, split, lo, hi, device, stream);
}

extern "C" int tauv_deform_conv_bf16(const void* x_nchw, const void* x, const void* offset,
                                     const void* mask, const void* taps, const void* bias,
                                     void* out, void* partial, int B, int C, int H, int W,
                                     int O, int bm, int bn, int split, int lo, int hi,
                                     int device, void* stream) {
  return dispatch<__nv_bfloat16>(x_nchw, x, offset, mask, taps, bias, out, partial, B, C, H,
                                 W, O, bm, bn, split, lo, hi, device, stream);
}
