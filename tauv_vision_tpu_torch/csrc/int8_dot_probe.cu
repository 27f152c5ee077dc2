// P2: the tensor cores' int8 (and bf16) dot rate inside a kernel written
// here, the question the int8 chain's own GEMM cores (kernel D, a later
// implicit-GEMM int8 conv) will be held to.
//
// Replaces tauv_vision_tpu/scripts/mosaic_int8_dot_probe.py: kernel_fn
// (the pallas_call at :64).  Same work: out = sum over r = 1..reps of
// roll(A, -r rows) @ B, A [M, K], B [K, N], int8 -> int32 or bf16 -> f32;
// each product reads A rotated by one more row, so no two are the same.
//
// What bounds it: operations, 2 M K N reps of them on 2 (M + N) K bytes
// of input.  The GEMM core is warp-level mma.sync (m16n8k32 s8 and
// m16n8k16 bf16, inline PTX), not wgmma, so it can reach only part of the
// card's peak; the probe measures which part.  Design: a block of 4 warps
// owns a 64 x 64 tile of out and reps / splits of the products
// (blockIdx.z picks which).  The products of consecutive r read A rows
// shifted by one, so a block stages the 63 + reps / splits rows they
// span and the 64 rows of B^T (B given transposed, K contiguous) in
// shared memory once a 256-byte slice of K, rows padded by 16 bytes so
// the fragment loads of a warp hit 32 distinct banks.  Per 32 bytes of K
// a warp loads the B fragments of its 8 column tiles into registers
// once and reuses them for every product, all of which sum into the same
// accumulators: 4 + 16 / (reps / splits) shared loads a mma.  In bytes,
// an m16n8k32 s8 fragment and an m16n8k16 bf16 fragment are the same (32
// bytes of K a step, thread t of a quad holding bytes 4t and 4t + 16),
// so one loop serves both.  With splits > 1 the blocks add their tiles
// into the zeroed output with atomics: integer sums, and in f32 sums of
// integers below 2^24, are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;
constexpr int kMaxReps = 16;           // products a block
constexpr int kChunk = 256;            // bytes of K staged at a time
constexpr int kStride = kChunk + 16;   // padded row, bytes

__device__ __forceinline__ void mma(bool int8, const uint32_t a[4],
                                    const uint32_t b[2], uint32_t c[4]) {
  if (int8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads) dot_probe_kernel(
    const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
    void* __restrict__ out, int M, int N, int row_bytes, int reps,
    int splits) {
  __shared__ __align__(16) uint8_t as[(kTile + kMaxReps) * kStride];
  __shared__ __align__(16) uint8_t bs[kTile * kStride];
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int per_split = reps / splits;
  const int a_rows = kTile + per_split - 1;
  // rows m0 + r + i (mod M) for r in [r0, r0 + per_split), i < 64
  const int r0 = 1 + blockIdx.z * per_split;

  // acc[nt][i]: int32 or f32 bits, rows 16 warp + g (i < 2) or + 8.
  uint32_t acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0u;  // 0 and 0.0f alike

  for (int cb = 0; cb < row_bytes; cb += kChunk) {
    for (int i = tid; i < a_rows * (kChunk / 16); i += kThreads) {
      const int row = i / (kChunk / 16);
      const int seg = i % (kChunk / 16);
      *reinterpret_cast<uint4*>(as + row * kStride + seg * 16) =
          *reinterpret_cast<const uint4*>(
              a + (long long)((m0 + r0 + row) % M) * row_bytes + cb + seg * 16);
    }
    for (int i = tid; i < kTile * (kChunk / 16); i += kThreads) {
      const int row = i / (kChunk / 16);
      const int seg = i % (kChunk / 16);
      *reinterpret_cast<uint4*>(bs + row * kStride + seg * 16) =
          *reinterpret_cast<const uint4*>(
              bt + (long long)(n0 + row) * row_bytes + cb + seg * 16);
    }
    __syncthreads();
#pragma unroll 1
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      const int kb = ks * 32 + 4 * t;
      uint32_t bf[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint8_t* brow = bs + (8 * nt + g) * kStride + kb;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(brow);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(brow + 16);
      }
#pragma unroll 4
      for (int r = 0; r < per_split; ++r) {
        const uint8_t* arow = as + (16 * warp + g + r) * kStride + kb;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(arow);
        af[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * kStride);
        af[2] = *reinterpret_cast<const uint32_t*>(arow + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(arow + 8 * kStride + 16);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma(kInt8, af, bf[nt], acc[nt]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + 16 * warp + g + 8 * (i >> 1);
      const int col = n0 + 8 * nt + 2 * t + (i & 1);
      const long long idx = (long long)row * N + col;
      if (kInt8) {
        int* o = static_cast<int*>(out) + idx;
        if (splits == 1) *o = (int)acc[nt][i];
        else atomicAdd(o, (int)acc[nt][i]);
      } else {
        float* o = static_cast<float*>(out) + idx;
        if (splits == 1) *o = __uint_as_float(acc[nt][i]);
        else atomicAdd(o, __uint_as_float(acc[nt][i]));
      }
    }
  }
}

}  // namespace

// a [M, K] and bt [N, K] (B transposed) int8 (kind 0) or bf16 (kind 1),
// contiguous and 16-byte aligned; out [M, N] int32 (kind 0) or f32
// (kind 1), zeroed by the caller when splits > 1.  M and N multiples of
// 64, K bytes a multiple of 256, reps a multiple of splits and reps /
// splits at most 16.  Returns cudaGetLastError() after the launch.
extern "C" int tauv_int8_dot_probe(const void* a, const void* bt, void* out,
                                   int M, int N, int K, int reps, int kind,
                                   int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int row_bytes = K * (kind == 0 ? 1 : 2);
  const dim3 grid(M / kTile, N / kTile, splits);
  if (kind == 0) {
    dot_probe_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)a, (const uint8_t*)bt, out, M, N, row_bytes, reps,
        splits);
  } else {
    dot_probe_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)a, (const uint8_t*)bt, out, M, N, row_bytes, reps,
        splits);
  }
  return (int)cudaGetLastError();
}
