// Packed-int4 weight-only dequant-fused matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_k x'[m, k] * (u[k, n] - zero[k / block, n]) * scale[k / block, n]
//
// x (M, K) f32 row-major; q (K/2, N) int8 row-major holding raw unsigned
// nibbles: byte [r, n] carries u[r, n] in its low nibble and u[K/2 + r, n] in
// its high nibble (the two K-halves are contiguous, not interleaved); scale,
// zero (K / block, N) f32 with an UNSIGNED zero; out (M, N) f32. x' = x, or x
// rounded to bf16 (round to nearest even) in the "bf16" mode.
//
// Replaces the Pallas TPU kernel asr_tpu/ops/quant_matmul.py:_kernel_p4
// (quant_matmul_pallas_p4). That kernel walked a sequential K/2 grid axis
// with an f32 VMEM accumulator and fed each nibble plane to the MXU against
// the matching half of x: in bf16 mode the raw nibbles, with the block
// affine applied as a rank-1 correction; in f32 mode the dequantized weight
// at HIGHEST precision. The two modes keep those two formulations here:
//
// bf16 mode (every serving path): tensor cores, packed_common.cuh, with the
// raw nibbles as mma.sync's B operand, 16-byte cp.async weight staging and
// the split-K plan of the wrapper (asr_tpu_torch/ops/quant_matmul.py,
// packed_plan).
//
// f32 mode (the exact replays): the CUDA-core kernel below, unchanged from
// its first design. Each block owns one BM x BN output tile and loops over
// K/2; every packed byte is read once, split into its two nibbles and
// dequantized in registers as both halves are staged into shared memory.
// Every output is one fmaf chain over k in the same order for every tile
// shape: for each step of BK packed rows, the BK low-half rows, then the BK
// high-half rows. So a row of a batched call equals the row alone.
//
// What bounds it on an H100 (3.35 TB/s; bf16 tensor cores 989 TFLOP/s): a
// call does 2*M*K*N operations and moves K*N/2 weight bytes, 8*K*N/block
// scale and zero bytes and 4*(M*K + M*N) activation bytes. At M = 1 .. 16
// (the tied head, the micro-batcher's and the slots' calls) that is 4-60
// operations per byte, far under the ridge (295): bytes bound, so the design
// is about bytes in flight: 16-byte loads, a 4-stage ring, and split-K so
// that (N/BN) * S blocks cover the 132 SMs where N/BN alone would not
// (16 blocks at N = 1024 in the first design). At the prefill's M ~ 430 it
// is ~700 operations per byte: operations bound, and mma.sync takes the
// products that the first design ran on the f32 CUDA cores (67 TFLOP/s).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 14): the
// small-M calls take 8-13 us, bound by latency (the x-staging kernel, the
// first stage's DRAM round trip, the cluster reduction), not by their
// 1.2-3.6 MB; the head streams at ~1.25 TB/s; the prefill shapes reach
// 40-50 TFLOP/s, bound by staging x once per column tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_common.cuh"

namespace {

constexpr int BK = 32;  // packed rows staged per step (2 * BK rows of K)

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_int4_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ scale, const float* __restrict__ zero,
                         float* __restrict__ out, int M, int K, int N, int block) {
  constexpr int TX = BN / TN;             // threads along N
  constexpr int TY = BM / TM;             // threads along M
  constexpr int THREADS = TX * TY;
  __shared__ float xs[2 * BK][BM + 1];    // x tile, transposed: rows [0, BK) low half, [BK, 2BK) high
  __shared__ float ws[2 * BK][BN];        // dequantized weight rows in the same order

  const int tid = threadIdx.x;
  const int tx = tid % TX;  // output columns tx + j * TX
  const int ty = tid / TX;  // output rows    ty + i * TY
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int K2 = K / 2;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K2; k0 += BK) {
    // x: row r, staged column c < BK is k = k0 + c, column BK + c is K/2 + k0 + c.
    for (int e = tid; e < BM * 2 * BK; e += THREADS) {
      const int r = e / (2 * BK);
      const int c = e % (2 * BK);
      const int gm = m0 + r;
      const int gk = (c < BK) ? k0 + c : K2 + k0 + (c - BK);
      float v = gm < M ? x[(size_t)gm * K + gk] : 0.f;
      xs[c][r] = v;
    }
    // weights: one byte read feeds one row of each half.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (gn < N) {
        const unsigned u = static_cast<unsigned>(static_cast<uint8_t>(q[(size_t)gk * N + gn]));
        const size_t s0 = (size_t)(gk / block) * N + gn;
        const size_t s1 = (size_t)((K2 + gk) / block) * N + gn;
        lo = ((float)(u & 0xFu) - zero[s0]) * scale[s0];
        hi = ((float)(u >> 4) - zero[s1]) * scale[s1];
      }
      ws[r][c] = lo;
      ws[BK + r][c] = hi;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < 2 * BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch_f32(const float* x, const int8_t* q, const float* s, const float* z, float* o, int M,
                int K, int N, int block, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  constexpr int threads = (BM / TM) * (BN / TN);
  quant_matmul_int4_kernel<BM, BN, TM, TN><<<grid, threads, 0, st>>>(x, q, s, z, o, M, K, N, block);
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// bf16_x != 0: the tensor-core route (packed_common.cuh) with the wrapper's
// plan: `splits` parts of whole scale blocks, tiles of bn x bm, and `ws` a
// workspace laid out as packed::Layout. bf16_x == 0: the f32 CUDA-core
// route, which ignores the plan and the workspace. The caller checks shapes, types,
// contiguity and 16-byte alignment and guarantees block % 32 == 0 and
// (K / 2) % block == 0.
extern "C" int quant_matmul_int4(const void* x, const void* q, const void* scale,
                                 const void* zero, void* out, void* ws, int M, int K, int N,
                                 int block, int bf16_x, int splits, int bn, int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  const float* zf = static_cast<const float*>(zero);
  float* of = static_cast<float*>(out);
  if (bf16_x) {
    const packed::Args a{xf, static_cast<const uint8_t*>(q), sf, zf, of, static_cast<float*>(ws),
                         M, K, N, block, splits};
    return packed::launch_bf16<2>(a, bn, bm, st);
  }
  const int8_t* qi = static_cast<const int8_t*>(q);
  if (M <= 16) {
    launch_f32<8, 64, 1, 2>(xf, qi, sf, zf, of, M, K, N, block, st);
  } else {
    launch_f32<64, 64, 4, 4>(xf, qi, sf, zf, of, M, K, N, block, st);
  }
  return static_cast<int>(cudaGetLastError());
}
