// Packed-int2 weight-only dequant-fused matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_k x'[m, k] * (u[k, n] - zero[k / block, n]) * scale[k / block, n]
//
// x (M, K) f32 row-major; q (K/4, N) int8 row-major holding raw unsigned
// 2-bit values: bit pair 2j:2j+2 of byte [r, n] carries u[j * K/4 + r, n]
// (four contiguous K-quarters, not interleaved); scale, zero (K / block, N)
// f32 with an UNSIGNED zero; out (M, N) f32. x' = x, or x rounded to bf16
// (round to nearest even) in the "bf16" mode. The sum is accumulated in f32.
//
// Replaces the Pallas TPU kernel asr_tpu/ops/quant_matmul.py:_kernel_p2
// (quant_matmul_pallas_p2). That kernel walked a sequential K/4 grid axis
// with an f32 VMEM accumulator, fed each 2-bit plane to the MXU against the
// matching quarter of x, and applied the block affine as a rank-1
// correction in bf16 mode. Here each block owns one BM x BN output tile and
// loops over K/4 itself; every packed byte is read once, split into its four
// planes and dequantized in registers as the four quarters are staged into
// shared memory, so the f32 weight never exists in device memory. The
// design is the int4 kernel's (quant_matmul_int4.cu) with four planes in
// place of two; BK is halved to 16 packed rows so the staged tiles stay at
// the int4 kernel's 33 KB of static shared memory.
//
// Summation order. Every output is one fmaf chain over k in the same order
// for every tile shape: for each step of BK packed rows, plane 0's BK rows,
// then planes 1, 2 and 3. So a row of a batched call equals the same row
// computed alone, bit for bit, whichever tile the launcher picks: the
// micro-batcher's and the continuous server's ids rely on it.
//
// What bounds it on an H100 (3.35 TB/s; f32 CUDA cores 67 TFLOP/s): a call
// does 2*M*K*N FLOPs and moves K*N/4 weight bytes, 8*K*N/block scale and
// zero bytes (at block 128 that is 20 % of the weight-side bytes) and
// 4*(M*K + M*N) activation bytes. At M = 1 .. 8 (decode steps, the
// micro-batcher, the continuous server's slots) that is 6-50 FLOP per byte:
// bytes bound. At a 30 s prefill's M = 432 it is past the ridge: bound by
// the cores. Two tile shapes: 64 x 64 (4 x 4 outputs a thread) for M > 16,
// and 8 x 64 (1 x 2 a thread) for M <= 16, which wastes no FMAs on padding
// rows and gives the weight-streaming calls N/64 blocks.
//
// Left for later: tensor cores (wgmma with bf16 A and 2-bit->bf16 B), TMA /
// cp.async multi-stage staging, wide (16-byte) weight loads, scales staged
// once a block row, and split-K for the M = 1 shapes with few columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;      // packed rows staged per step (4 * BK rows of K)
constexpr int PLANES = 4;

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BM, int BN, int TM, int TN, bool kBf16X>
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
      if (kBf16X) v = round_to_bf16(v);
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
void launch(const float* x, const int8_t* q, const float* s, const float* z, float* o, int M,
            int K, int N, int block, bool bf16_x, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  constexpr int threads = (BM / TM) * (BN / TN);
  if (bf16_x) {
    quant_matmul_int2_kernel<BM, BN, TM, TN, true><<<grid, threads, 0, st>>>(x, q, s, z, o, M, K, N,
                                                                            block);
  } else {
    quant_matmul_int2_kernel<BM, BN, TM, TN, false><<<grid, threads, 0, st>>>(x, q, s, z, o, M, K,
                                                                             N, block);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and contiguity and guarantees
// (K / 4) % block == 0 and (K / 4) % 16 == 0.
extern "C" int quant_matmul_int2(const void* x, const void* q, const void* scale,
                                 const void* zero, void* out, int M, int K, int N, int block,
                                 int bf16_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  const float* zf = static_cast<const float*>(zero);
  float* of = static_cast<float*>(out);
  if (M <= 16) {
    launch<8, 64, 1, 2>(xf, qi, sf, zf, of, M, K, N, block, bf16_x != 0, st);
  } else {
    launch<64, 64, 4, 4>(xf, qi, sf, zf, of, M, K, N, block, bf16_x != 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}
