// Int8 weight-only dequant-fused matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_k x'[m, k] * (q[k, n] - zero[k / block, n]) * scale[k / block, n]
//
// x (M, K) f32 row-major; q (K, N) int8 row-major, stored centered (q - 128);
// scale, zero (K / block, N) f32, zero centered (zero - 128); out (M, N) f32.
// x' = x, or x rounded to bf16 (round to nearest even) in the "bf16" mode.
// The sum is accumulated in f32.
//
// Replaces the Pallas TPU kernel asr_tpu/ops/quant_matmul.py:_kernel
// (quant_matmul_pallas). That kernel walked a sequential K grid axis with an
// f32 VMEM accumulator and, in bf16 mode, fed raw ints to the MXU with a
// rank-1 zero-point correction (x@q)*s - rowsum(x)*(z*s) to save VPU work.
// Here each block owns one 64x64 output tile and loops over K itself; each
// weight is dequantized in registers as it is staged into shared memory, so
// the f32 weight never exists in device memory and no correction term is
// needed (the sums agree up to f32 rounding order).
//
// What bounds it on an H100 (f32 CUDA cores: 67 TFLOP/s peak, 3.35 TB/s):
// a call does 2*M*K*N FLOPs and moves K*N weight bytes plus 4*(M*K + M*N)
// activation bytes. SenseVoiceSmall's FFN w1 (K=512, N=2048):
//   M = 1096 (batch 8 x 137 rows): 2.30 GFLOP over 12.3 MB -> 187 FLOP/byte;
//   M =  137 (one request):        0.29 GFLOP over  2.4 MB -> 117 FLOP/byte.
// The f32 ridge is 67e12 / 3.35e12 = 20 FLOP/byte, so both are FLOP-bound on
// the CUDA cores; weight bytes (2*M FLOP per weight byte) bound it only for
// M below ~10. On tensor cores (bf16 989 TFLOP/s, ridge ~295) the same calls
// sit at the weight-byte ridge from M ~ 150 down, which is where the slice's
// single-request shapes are.
//
// Left for later: tensor cores (wgmma with bf16 A and int8->bf16 B, or int8
// MMA with a dynamic activation scale), TMA / cp.async multi-stage staging,
// a split-K or stream-K schedule for the small-M shapes that fill few of
// the 132 SMs, and wider per-thread tiles with vector shared-memory loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, each owns a 4 x 4 sub-tile
constexpr int TM = 4;
constexpr int TN = 4;

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16X>
__global__ void __launch_bounds__(THREADS)
quant_matmul_int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ scale, const float* __restrict__ zero,
                         float* __restrict__ out, int M, int K, int N, int block) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed; +1 keeps the staging stores conflict-free
  __shared__ float ws[BK][BN];      // dequantized weight tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx, tx + 16, tx + 32, tx + 48
  const int ty = tid / 16;  // output rows    ty, ty + 16, ty + 32, ty + 48
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: a warp reads 32 consecutive k of one row (128 contiguous bytes).
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      float v = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      if (kBf16X) v = round_to_bf16(v);
      xs[c][r] = v;
    }
    // weight tile: int8 read, dequantized with its block's scale and zero.
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      float w = 0.f;
      if (gk < K && gn < N) {
        const size_t sz = (size_t)(gk / block) * N + gn;
        w = ((float)q[(size_t)gk * N + gn] - zero[sz]) * scale[sz];
      }
      ws[r][c] = w;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * 16];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * 16];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * 16;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * 16;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes, types and contiguity and guarantees K % block == 0.
extern "C" int quant_matmul_int8(const void* x, const void* q, const void* scale,
                                 const void* zero, void* out, int M, int K, int N,
                                 int block, int bf16_x, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  const float* zf = static_cast<const float*>(zero);
  float* of = static_cast<float*>(out);
  if (bf16_x) {
    quant_matmul_int8_kernel<true><<<grid, THREADS, 0, s>>>(xf, qi, sf, zf, of, M, K, N, block);
  } else {
    quant_matmul_int8_kernel<false><<<grid, THREADS, 0, s>>>(xf, qi, sf, zf, of, M, K, N, block);
  }
  return static_cast<int>(cudaGetLastError());
}
