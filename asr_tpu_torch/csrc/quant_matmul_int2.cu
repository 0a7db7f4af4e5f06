// Packed-int2 weight-only dequant-fused matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_k x'[m, k] * (u[k, n] - zero[k / block, n]) * scale[k / block, n]
//
// x (M, K) f32 row-major; q (K/4, N) int8 row-major holding raw unsigned
// 2-bit values: bit pair 2j:2j+2 of byte [r, n] carries u[j * K/4 + r, n]
// (four contiguous K-quarters, not interleaved); scale, zero (K / block, N)
// f32 with an UNSIGNED zero; out (M, N) f32. x' = x, or x rounded to bf16
// (round to nearest even) in the "bf16" mode.
//
// Replaces the Pallas TPU kernel asr_tpu/ops/quant_matmul.py:_kernel_p2
// (quant_matmul_pallas_p2). That kernel walked a sequential K/4 grid axis
// with an f32 VMEM accumulator and fed each 2-bit plane to the MXU against
// the matching quarter of x: in bf16 mode the raw values, with the block
// affine applied as a rank-1 correction; in f32 mode the dequantized weight
// at HIGHEST precision. The two modes keep those two formulations here:
//
// bf16 mode (every serving path): tensor cores, packed_common.cuh (the int4
// kernel's route with four planes), raw 2-bit values as mma.sync's B
// operand, 16-byte cp.async weight staging, the wrapper's split-K plan.
// The micro-batcher's and the continuous server's ids rely on its rows
// being bitwise the row alone; packed_common.cuh says why they are.
//
// f32 mode (the exact replays): the CUDA-core kernel below, unchanged from
// its first design (the int4 kernel's with four planes, BK halved to 16
// packed rows). Every output is one fmaf chain over k in the same order for
// every tile shape: for each step of BK packed rows, plane 0's BK rows,
// then planes 1, 2 and 3. So a row of a batched call equals the row alone.
//
// What bounds it on an H100 (3.35 TB/s; bf16 tensor cores 989 TFLOP/s): a
// call does 2*M*K*N operations and moves K*N/4 weight bytes, 8*K*N/block
// scale and zero bytes (at block 128 a fifth of the weight-side bytes) and
// 4*(M*K + M*N) activation bytes. At M = 1 .. 16 (decode steps, the
// micro-batcher, the continuous server's slots) that is 6-100 operations per
// byte: bytes bound, and at these sizes (0.25-1.5 MB of weights) the
// launch and the last block's tail weigh as much as the bytes; split-K
// brings (N/BN) * S blocks to at least the 132 SMs. At a 30 s prefill's
// M = 432 it is operations bound, on mma.sync. Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 21): 7.8-10.7 us a call at M = 1..8,
// bound by latency as the int4 kernel's; 37-51 TFLOP/s at M = 432.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_common.cuh"

namespace {

constexpr int BK = 16;      // packed rows staged per step (4 * BK rows of K)
constexpr int PLANES = 4;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_int2_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ scale, const float* __restrict__ zero,
                         float* __restrict__ out, int M, int K, int N, int block) {
  constexpr int TX = BN / TN;             // threads along N
  constexpr int TY = BM / TM;             // threads along M
  constexpr int THREADS = TX * TY;
  constexpr int ROWS = PLANES * BK;       // rows of K per step
  __shared__ float xs[ROWS][BM + 1];      // x tile, transposed: rows [j*BK, (j+1)*BK) = plane j
  __shared__ float ws[ROWS][BN];          // dequantized weight rows in the same order

  const int tid = threadIdx.x;
  const int tx = tid % TX;  // output columns tx + j * TX
  const int ty = tid / TX;  // output rows    ty + i * TY
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int K4 = K / 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K4; k0 += BK) {
    // x: row r, staged column c is k = (c / BK) * K/4 + k0 + c % BK.
    for (int e = tid; e < BM * ROWS; e += THREADS) {
      const int r = e / ROWS;
      const int c = e % ROWS;
      const int gm = m0 + r;
      const int gk = (c / BK) * K4 + k0 + (c % BK);
      float v = gm < M ? x[(size_t)gm * K + gk] : 0.f;
      xs[c][r] = v;
    }
    // weights: one byte read feeds one row of each quarter.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      unsigned u = 0;
      if (gn < N) u = static_cast<unsigned>(static_cast<uint8_t>(q[(size_t)gk * N + gn]));
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        float w = 0.f;
        if (gn < N) {
          const size_t s = (size_t)((p * K4 + gk) / block) * N + gn;
          w = ((float)((u >> (2 * p)) & 0x3u) - zero[s]) * scale[s];
        }
        ws[p * BK + r][c] = w;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < ROWS; ++kk) {
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
  quant_matmul_int2_kernel<BM, BN, TM, TN><<<grid, threads, 0, st>>>(x, q, s, z, o, M, K, N, block);
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// bf16_x != 0: the tensor-core route (packed_common.cuh) with the wrapper's
// plan: `splits` parts of whole scale blocks, tiles of bn x bm, and `ws` a
// workspace laid out as packed::Layout. bf16_x == 0: the f32 CUDA-core
// route, which ignores the plan and the workspace. The caller checks shapes, types,
// contiguity and 16-byte alignment and guarantees block % 32 == 0 and
// (K / 4) % block == 0.
extern "C" int quant_matmul_int2(const void* x, const void* q, const void* scale,
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
    return packed::launch_bf16<4>(a, bn, bm, st);
  }
  const int8_t* qi = static_cast<const int8_t*>(q);
  if (M <= 16) {
    launch_f32<8, 64, 1, 2>(xf, qi, sf, zf, of, M, K, N, block, st);
  } else {
    launch_f32<64, 64, 4, 4>(xf, qi, sf, zf, of, M, K, N, block, st);
  }
  return static_cast<int>(cudaGetLastError());
}
