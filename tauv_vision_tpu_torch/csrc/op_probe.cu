// P1: the cost of the operations a fused conv for short contractions is
// built from, measured inside kernels written here.
//
// Replaces tauv_vision_tpu/scripts/mosaic_op_probe.py, the pallas_calls
// at :126 (dot), :190 (slice copy), :227 (lane-shift copy), :269
// (decimation, three variants) and :309 (transpose).  On the TPU it asked
// whether the CenterNet's early trunk (the 7x7 stem, level0, level1: C_in
// = 3, 16, 32) could be one kernel that accumulates a short-K dot per tap
// and builds its patches by shifted copies in fast memory.  Here it asks
// the same of Hopper: a tap-accumulation conv (K = C_in a tap, patches by
// shifted reads from shared memory) against im2col (K = 9 C_in).
//
// Each kernel repeats one operation n_iter times on operands staged in
// shared memory, each iteration reading an iteration-dependent slice, and
// writes what the JAX kernel writes: the last iteration's buffer, or the
// dot's accumulator bank 0.  Shared-memory accesses are inline PTX
// (asm volatile), so no iteration is hoisted or elided; the caller times
// n_iter and 2 n_iter and takes the difference, so staging and launch
// cancel.  What bounds each: the dots, tensor-core operations (989
// TFLOP/s bf16 dense on the card); the copies, shared-memory bytes (128
// bytes a clock an SM).
//
// The TPU held each operand in one core's VMEM; an SM has 227 KB, so an
// operand that does not fit is split over blocks, each block holding its
// share in shared memory:
//  - dot: [2K, N] bf16 is 655 KB at K = 256, N = 640, and 4 f32 banks of
//    [M, N] are 1.3 MB at M = 128.  A block is one warp and holds a 16 x
//    32 tile of the output: W's 16 rows [16, K] and X's 32 columns [2K,
//    32] in shared memory, its 4 banks in registers (64 floats a
//    thread).  Grid (N / 32, M / 16).  Fragments come by ldmatrix (X's by
//    ldmatrix.trans, row-major as given), products by mma.sync m16n8k16
//    bf16 -> f32, as probe P2.
//  - slice copy: x [18, 16, 642] bf16 (370 KB) and the [160, 642] buffer
//    are split by columns over 3 blocks of 216 (27 16-byte chunks), rows
//    padded to 648 elements so every row starts 16-byte aligned; each
//    block copies its columns with 16-byte loads and stores.
//  - lane shift: the same source, split over 4 blocks of 160 output
//    columns (each holding 168 source columns, 8 of halo).  A source
//    shifted by 1 or 2 elements (2 or 4 bytes) is not 16-byte aligned, so
//    each 16-byte output chunk is built from the two aligned source
//    chunks it straddles by byte permutes (prmt): 2 loads, 1 store.
//  - decimate: x [8, 32, 640] f32 (655 KB) split by rows over 4 blocks of
//    8; strided (a 4-byte load of every other element), reshape_minor (an
//    8-byte load of each pair, the first kept) and transpose_first (the
//    map transposed into shared memory, then every other row read back).
//  - transpose: x [8, 32, 320] f32 (328 KB) split by columns over 2 blocks
//    of 160; each thread reads two rows of one column and writes one
//    32-bit word of two bf16 (round to nearest even) into the [320, 32]
//    buffer, whose rows are padded to 34 elements against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- shared-memory access that the compiler keeps -----------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};" ::"r"(a), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// ---- dot ---------------------------------------------------------------

constexpr int kBanks = 4;
constexpr int kDotCols = 32;                 // output columns a block
constexpr int kXStride = kDotCols + 8;       // bf16, 80 bytes a row

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w [M, K], x [2K, N] bf16 row-major; out [M, N] f32 = bank 0 of
// banks[i % 4] += w @ x[(i % 2) K : (i % 2) K + K] for i < n_iter.
__global__ void __launch_bounds__(32) dot_kernel(
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ x,
    float* __restrict__ out, int K, int N, int n_iter) {
  extern __shared__ __align__(16) uint8_t dyn[];
  const int ws = K + 8;  // bf16 a row of W's tile
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(dyn);
  __nv_bfloat16* X = W + 16 * ws;
  const int m0 = blockIdx.y * 16, n0 = blockIdx.x * kDotCols;
  const int lane = threadIdx.x;

  for (int i = lane; i < 16 * (K / 8); i += 32) {
    const int r = i / (K / 8), ch = i % (K / 8);
    *reinterpret_cast<uint4*>(W + r * ws + ch * 8) =
        *reinterpret_cast<const uint4*>(w + (long long)(m0 + r) * K + ch * 8);
  }
  for (int i = lane; i < 2 * K * (kDotCols / 8); i += 32) {
    const int r = i / (kDotCols / 8), ch = i % (kDotCols / 8);
    *reinterpret_cast<uint4*>(X + r * kXStride + ch * 8) =
        *reinterpret_cast<const uint4*>(x + (long long)r * N + n0 + ch * 8);
  }
  __syncthreads();

  float acc[kBanks][4][4];
#pragma unroll
  for (int b = 0; b < kBanks; ++b)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][nt][e] = 0.f;

  const uint32_t a_lane = smem(W + (lane & 15) * ws + (lane >> 4) * 8);
  const uint32_t x_lane = smem(X + (lane & 15) * kXStride + (lane >> 4) * 8);
  for (int i0 = 0; i0 < n_iter; i0 += kBanks) {
#pragma unroll
    for (int b = 0; b < kBanks; ++b) {
      if (i0 + b >= n_iter) break;
      const int koff = (b & 1) * K;  // i % 2 with i = i0 + b, i0 % 4 == 0
      for (int ks = 0; ks < K; ks += 16) {
        uint32_t a[4], lo[4], hi[4];
        ldmatrix_x4(a, a_lane + ks * 2);
        ldmatrix_x4_trans(lo, x_lane + (koff + ks) * kXStride * 2);
        ldmatrix_x4_trans(hi, x_lane + (koff + ks) * kXStride * 2 + 32);
        mma_bf16(acc[b][0], a, lo[0], lo[1]);
        mma_bf16(acc[b][1], a, lo[2], lo[3]);
        mma_bf16(acc[b][2], a, hi[0], hi[1]);
        mma_bf16(acc[b][3], a, hi[2], hi[3]);
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + 8 * (e >> 1);
      const int col = n0 + 8 * nt + 2 * t + (e & 1);
      out[(long long)row * N + col] = acc[0][nt][e];
    }
}

// ---- slice copy and lane-shift copy ------------------------------------

constexpr int kCopyThreads = 256;
constexpr int kSlabs = 18, kRows = 16, kLen = 642;
constexpr int kPadChunks = 81;      // 648 bf16 a padded row, 16-byte chunks
constexpr int kCopyChunks = 27;     // slice copy: chunks a block (3 blocks)
constexpr int kCopyBufRows = 160;
constexpr int kShiftChunks = 20;    // lane shift: output chunks a block (4)
constexpr int kShiftOut = 640;

// Stage x[:, :, c0 : c0 + 8 n_chunks] (zero past the row's end) into
// src [kSlabs][kRows][n_chunks * 8], by bf16 pairs: a global row of 642
// bf16 is 4-byte but not 16-byte aligned.
__device__ void stage_copy_source(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* src, int c0, int n_chunks) {
  const int pairs = n_chunks * 4;
  for (int i = threadIdx.x; i < kSlabs * kRows * pairs; i += blockDim.x) {
    const int row = i / pairs, p = i % pairs;
    const int col = c0 + 2 * p;
    uint32_t v = 0u;
    if (col < kLen)
      v = *reinterpret_cast<const uint32_t*>(x + (long long)row * kLen + col);
    *reinterpret_cast<uint32_t*>(src + row * n_chunks * 8 + 2 * p) = v;
  }
}

__global__ void __launch_bounds__(kCopyThreads) copy_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    int shifted, int n_iter) {
  extern __shared__ __align__(16) uint8_t dyn[];
  const int src_chunks = shifted ? kShiftChunks + 1 : kCopyChunks;
  const int buf_chunks = shifted ? kShiftChunks : kCopyChunks;
  const int buf_rows = shifted ? 2 * kRows : kCopyBufRows;
  const int c0 = blockIdx.x * buf_chunks * 8;
  __nv_bfloat16* src = reinterpret_cast<__nv_bfloat16*>(dyn);
  __nv_bfloat16* buf = src + kSlabs * kRows * src_chunks * 8;
  stage_copy_source(x, src, c0, src_chunks);
  for (int i = threadIdx.x; i < buf_rows * buf_chunks * 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(buf)[i] = 0u;
  __syncthreads();

  const uint32_t s0 = smem(src), b0 = smem(buf);
  const int slab_bytes = kRows * src_chunks * 16;
  const int n_work = kRows * buf_chunks;  // 16-byte chunks a copy
  for (int it = 0; it < n_iter; ++it) {
    const int j = it % 16;
    for (int w = threadIdx.x; w < n_work; w += blockDim.x) {
      const int r = w / buf_chunks, ch = w % buf_chunks;
      if (!shifted) {
        // buf[3:19] = x[j]; buf[21:37] = x[j + 1]; buf[40:56] = x[j + 2]
        const int dst_rows[3] = {3, 21, 40};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const uint4 v = lds128(s0 + (j + c) * slab_bytes + (r * src_chunks + ch) * 16);
          sts128(b0 + ((dst_rows[c] + r) * buf_chunks + ch) * 16, v);
        }
      } else {
        // buf[0:16] = x[j, :, 1:641]; buf[16:32] = x[j, :, 2:642]; each
        // copy reads its own two source chunks, as the two slices do.
        const uint32_t a = s0 + j * slab_bytes + (r * src_chunks + ch) * 16;
        const uint4 lo = lds128(a), hi = lds128(a + 16);
        sts128(b0 + (r * buf_chunks + ch) * 16,
               make_uint4(__byte_perm(lo.x, lo.y, 0x5432), __byte_perm(lo.y, lo.z, 0x5432),
                          __byte_perm(lo.z, lo.w, 0x5432), __byte_perm(lo.w, hi.x, 0x5432)));
        const uint4 lo2 = lds128(a), hi2 = lds128(a + 16);
        sts128(b0 + ((kRows + r) * buf_chunks + ch) * 16,
               make_uint4(lo2.y, lo2.z, lo2.w, hi2.x));
      }
    }
  }
  __syncthreads();

  const int out_len = shifted ? kShiftOut : kLen;
  for (int i = threadIdx.x; i < kRows * buf_chunks * 8; i += blockDim.x) {
    const int r = i / (buf_chunks * 8), e = i % (buf_chunks * 8);
    if (c0 + e < out_len)
      out[r * out_len + c0 + e] = buf[r * buf_chunks * 8 + e];
  }
}

// ---- decimation --------------------------------------------------------

constexpr int kDecThreads = 256;
constexpr int kDecSlabs = 8, kDecRows = 32, kDecLen = 640, kDecOut = 320;
constexpr int kDecBlockRows = 8;                 // 4 blocks
constexpr int kTmpStride = kDecBlockRows + 1;    // words a transposed row

__global__ void __launch_bounds__(kDecThreads) decimate_kernel(
    const float* __restrict__ x, float* __restrict__ out, int variant,
    int n_iter) {
  extern __shared__ __align__(16) uint8_t dyn[];
  float* src = reinterpret_cast<float*>(dyn);             // [8][8][640]
  float* buf = src + kDecSlabs * kDecBlockRows * kDecLen;  // [8][320]
  float* tmp = buf + kDecBlockRows * kDecOut;              // [640][9]
  const int r0 = blockIdx.x * kDecBlockRows;
  for (int i = threadIdx.x; i < kDecSlabs * kDecBlockRows * kDecLen / 4;
       i += blockDim.x) {
    const int e = i * 4;
    const int s = e / (kDecBlockRows * kDecLen);
    const int rest = e % (kDecBlockRows * kDecLen);
    *reinterpret_cast<float4*>(src + e) = *reinterpret_cast<const float4*>(
        x + ((long long)s * kDecRows + r0) * kDecLen + rest);
  }
  __syncthreads();

  const uint32_t s0 = smem(src), b0 = smem(buf), t0 = smem(tmp);
  const int slab = kDecBlockRows * kDecLen * 4;  // bytes
  const int n_out = kDecBlockRows * kDecOut;
  for (int it = 0; it < n_iter; ++it) {
    const uint32_t sj = s0 + (it % 8) * slab;
    if (variant == 0) {  // strided: buf = x[j, :, ::2]
      for (int w = threadIdx.x; w < n_out; w += blockDim.x) {
        const int r = w / kDecOut, c = w % kDecOut;
        sts32(b0 + w * 4, lds32(sj + (r * kDecLen + 2 * c) * 4));
      }
    } else if (variant == 1) {  // reshape_minor: pairs, the first kept
      for (int w = threadIdx.x; w < n_out; w += blockDim.x) {
        const int r = w / kDecOut, c = w % kDecOut;
        sts32(b0 + w * 4, lds64(sj + (r * kDecLen + 2 * c) * 4).x);
      }
    } else {  // transpose_first: t = x[j].T; buf = t[::2].T
      for (int w = threadIdx.x; w < kDecBlockRows * kDecLen; w += blockDim.x) {
        const int r = w / kDecLen, e = w % kDecLen;
        sts32(t0 + (e * kTmpStride + r) * 4, lds32(sj + w * 4));
      }
      __syncthreads();
      for (int w = threadIdx.x; w < n_out; w += blockDim.x) {
        const int r = w / kDecOut, c = w % kDecOut;
        sts32(b0 + w * 4, lds32(t0 + (2 * c * kTmpStride + r) * 4));
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_out; w += blockDim.x)
    out[r0 * kDecOut + w] = buf[w];
}

// ---- transpose ---------------------------------------------------------

constexpr int kTrThreads = 256;
constexpr int kTrSlabs = 8, kTrRows = 32, kTrLen = 320;
constexpr int kTrBlockCols = 160;             // 2 blocks
constexpr int kTrBufStride = kTrRows + 2;     // bf16 a buffer row

__global__ void __launch_bounds__(kTrThreads) transpose_kernel(
    const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
    int n_iter) {
  extern __shared__ __align__(16) uint8_t dyn[];
  float* src = reinterpret_cast<float*>(dyn);  // [8][32][160]
  __nv_bfloat16* buf =
      reinterpret_cast<__nv_bfloat16*>(src + kTrSlabs * kTrRows * kTrBlockCols);
  const int c0 = blockIdx.x * kTrBlockCols;
  for (int i = threadIdx.x; i < kTrSlabs * kTrRows * kTrBlockCols / 4;
       i += blockDim.x) {
    const int e = i * 4;
    const int row = e / kTrBlockCols, c = e % kTrBlockCols;
    *reinterpret_cast<float4*>(src + e) =
        *reinterpret_cast<const float4*>(x + (long long)row * kTrLen + c0 + c);
  }
  __syncthreads();

  const uint32_t s0 = smem(src), b0 = smem(buf);
  const int slab = kTrRows * kTrBlockCols * 4;
  for (int it = 0; it < n_iter; ++it) {
    const uint32_t sj = s0 + (it % 8) * slab;
    for (int w = threadIdx.x; w < (kTrRows / 2) * kTrBlockCols; w += blockDim.x) {
      const int r2 = w / kTrBlockCols, c = w % kTrBlockCols;
      const float v0 = __uint_as_float(lds32(sj + ((2 * r2) * kTrBlockCols + c) * 4));
      const float v1 = __uint_as_float(lds32(sj + ((2 * r2 + 1) * kTrBlockCols + c) * 4));
      const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);  // .x = row 2 r2
      sts32(b0 + (c * kTrBufStride + 2 * r2) * 2, *reinterpret_cast<const uint32_t*>(&p));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < kTrBlockCols * kTrRows; w += blockDim.x) {
    const int c = w / kTrRows, r = w % kTrRows;
    out[(c0 + c) * kTrRows + r] = buf[c * kTrBufStride + r];
  }
}

// Select the device and allow the kernel its dynamic shared memory.
template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

// w [M, K] and x [2K, N] bf16 contiguous, 16-byte aligned; out [M, N] f32.
// M a multiple of 16, K of 16 (at most 256), N of 32.
extern "C" int tauv_op_probe_dot(const void* w, const void* x, void* out,
                                 int M, int K, int N, int n_iter, int device,
                                 void* stream) {
  const int bytes = (16 * (K + 8) + 2 * K * kXStride) * 2;
  const int err = prepare(dot_kernel, bytes, device);
  if (err) return err;
  dot_kernel<<<dim3(N / kDotCols, M / 16), 32, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)w, (const __nv_bfloat16*)x, (float*)out, K, N,
      n_iter);
  return (int)cudaGetLastError();
}

// x [18, 16, 642] bf16; out [16, 642] (shifted 0: the slice copy's buffer
// rows 0-15) or [16, 640] (shifted 1: the lane-shift copy's).
extern "C" int tauv_op_probe_copy(const void* x, void* out, int shifted,
                                  int n_iter, int device, void* stream) {
  const int src_chunks = shifted ? kShiftChunks + 1 : kCopyChunks;
  const int buf_chunks = shifted ? kShiftChunks : kCopyChunks;
  const int buf_rows = shifted ? 2 * kRows : kCopyBufRows;
  const int blocks = shifted ? kShiftOut / (8 * kShiftChunks)
                             : kPadChunks / kCopyChunks;
  const int bytes = (kSlabs * kRows * src_chunks + buf_rows * buf_chunks) * 16;
  const int err = prepare(copy_kernel, bytes, device);
  if (err) return err;
  copy_kernel<<<blocks, kCopyThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, shifted, n_iter);
  return (int)cudaGetLastError();
}

// x [8, 32, 640] f32; out [32, 320] f32; variant 0 strided, 1
// reshape_minor, 2 transpose_first.
extern "C" int tauv_op_probe_decimate(const void* x, void* out, int variant,
                                      int n_iter, int device, void* stream) {
  const int bytes = (kDecSlabs * kDecBlockRows * kDecLen +
                     kDecBlockRows * kDecOut + kDecLen * kTmpStride) * 4;
  const int blocks = kDecRows / kDecBlockRows;
  const int err = prepare(decimate_kernel, bytes, device);
  if (err) return err;
  decimate_kernel<<<blocks, kDecThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, variant, n_iter);
  return (int)cudaGetLastError();
}

// x [8, 32, 320] f32; out [320, 32] bf16.
extern "C" int tauv_op_probe_transpose(const void* x, void* out, int n_iter,
                                       int device, void* stream) {
  const int bytes = kTrSlabs * kTrRows * kTrBlockCols * 4 +
                    kTrBlockCols * kTrBufStride * 2;
  const int blocks = kTrLen / kTrBlockCols;
  const int err = prepare(transpose_kernel, bytes, device);
  if (err) return err;
  transpose_kernel<<<blocks, kTrThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (__nv_bfloat16*)out, n_iter);
  return (int)cudaGetLastError();
}
