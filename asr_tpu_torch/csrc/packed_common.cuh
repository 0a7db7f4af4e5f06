// Tensor-core route of the packed-int4 and packed-int2 dequant matmuls
// (quant_matmul_int4.cu, quant_matmul_int2.cu) in bf16 mode, for Hopper
// (sm_90a).
//
//   out[m, n] = sum_k x16[m, k] * (u[k, n] - zero[k / block, n]) * scale[k / block, n]
//
// x (M, K) f32, rounded to bf16 (nearest even) as it is staged; q (K/P, N)
// bytes holding P planes of raw unsigned values (P = 2: nibbles, plane j =
// bits 4j..4j+3; P = 4: bit pairs 2j..2j+1), plane j of byte [r, n] being
// u[j * K/P + r, n]; scale, zero (K / block, N) f32, unsigned zero.
//
// Arithmetic: the TPU kernels' bf16 branch (asr_tpu/ops/quant_matmul.py,
// _kernel_p4 and _kernel_p2). The raw integers (exact in bf16) are the B
// operand of mma.sync m16n8k16 (bf16 in, f32 accumulate), so the weight is
// never rounded. For each scale block b of each plane j:
//   p  = sum over the block's k of x16 * u      (tensor cores, f32)
//   xs = sum over the block's k of x16          (f32)
//   acc += p * s - xs * (z * s)                  (f32, no contraction)
//
// Schedule. A first kernel (stage_x_kernel) rounds x to bf16 once and
// writes it in mma fragment order with its per-row chunk sums (xs). The
// matmul kernel starts beside it (programmatic dependent launch) and only
// copies: a block owns a BM x BN output tile and one split part, a run of
// whole scale blocks [b_lo, b_hi) of the packed rows, the same run in every
// plane, so each weight byte is read from device memory once and feeds all
// P planes' fragments. Each warp owns 16 rows x 8*NT columns. Stages of
// KS = 32 packed rows stream through a ring of NSTAGE slots in dynamic
// shared memory, filled by 16-byte cp.async: the weight rows, the x
// fragments and chunk sums of the block's m16 tiles, and, in the slot of a
// scale block's last stage, its scales and zeros. With S > 1 the parts of a
// tile form a thread block cluster and add their partial tiles through
// distributed shared memory in order 0..S-1. No float atomics.
//
// Row independence. The split (S and its boundaries), the k16 order, the
// fold (block by block, planes 0..P-1 within a block) and the combine order
// depend on (K, N, block, P) only; the row count M chooses only BM and the
// number of row tiles. Every output element is one row of A against one
// column of B, so a row of a batched call is bitwise the same row alone.
//
// Weight fragments. mma's B fragment wants, for column g = lane / 4, the
// k pairs (2t, 2t+1) and (2t+8, 2t+9), t = lane % 4. A thread reads one
// 32-bit (NT = 4) or 16-bit (NT = 2) word from each of those four staged
// rows: NT neighbouring columns. Column NT*g + i of the warp's slab is
// column g of n8 tile i, so one prmt per tile and k pair gathers the two
// bytes of a column, and per plane one lop3 puts the value into the
// mantissa of bf16 128.0 and one bf16x2 fma subtracts 128. The output
// columns of a thread then land on 2*NT neighbouring columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include <cooperative_groups.h>

// Internal linkage in every library that includes this header (the
// anonymous namespace), as in aed_step.cuh and qwen_common.cuh: see
// quant_matmul_int8.cu.
namespace packed {
namespace {

namespace cg = cooperative_groups;

// The dynamic shared-memory limit of one kernel, set once for each device
// it launches on: the CUDA runtime keeps a function's attributes per device
// context, so a limit set on one card does not hold on another. One static
// instance per launch site (inside a function template: per kernel); the
// calling thread's current device picks the bit.
struct SmemLimit {
  std::atomic<unsigned long long> done{0};  // bit d: set on device d

  template <typename Kernel>
  cudaError_t ensure(Kernel kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
    return err;
  }
};

constexpr int KS = 32;      // packed rows a pipeline stage holds (two k16 steps)
constexpr int NSTAGE = 4;   // depth of the cp.async ring
constexpr int BPAD = 16;    // padding bytes after each staged weight row
constexpr int MAX_SPLIT = 8;  // split parts of a tile: one cluster, at most the portable size

struct Args {
  const float* x;
  const uint8_t* q;
  const float* scale;
  const float* zero;
  float* out;  // (M, N)
  float* ws;   // workspace, see Layout
  int M, K, N, block, S;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Two raw values (bits 0.. of each 16-bit half of v, under mask) -> two bf16.
__device__ __forceinline__ uint32_t raw_to_bf16x2(uint32_t v, uint32_t mask) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(v), "r"(mask), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC300C300u));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Workspace layout (f32 words), mirrored by the wrapper's packed_workspace:
// x in bf16 fragment order (Mpad * K / 2 words), then the per-row sums xs
// of each stage chunk of KS rounded values (K / KS rows of Mpad, row
// j * K/P/KS + c for plane j, chunk c).
struct Layout {
  int mt, mpad;
  size_t xfrag, xs, total;
  __host__ __device__ Layout(int M, int K) {
    mt = (M + 15) / 16;
    mpad = 16 * mt;
    xfrag = 0;
    xs = xfrag + static_cast<size_t>(mpad) * K / 2;
    total = xs + static_cast<size_t>(K / KS) * mpad;
  }
};

// x (M, K) f32 -> bf16 (nearest even) in mma A-fragment order, and the row
// sum of each chunk of KS rounded values; rows M..Mpad-1 are zeros.
// Fragment order: [m16 tile][K/P/KS chunks][plane][k16 half][lane][4
// registers], so the x of one stage and m16 tile, every plane, is one
// contiguous P KB run that the matmul stages with cp.async. One thread per
// (row, plane, chunk); the sum runs over the chunk in k order.
template <int P>
__global__ void stage_x_kernel(const float* __restrict__ x, float* __restrict__ ws, int M, int K) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Layout L(M, K);
  const int kp = K / P, chunks = kp / KS;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= static_cast<long long>(L.mpad) * P * chunks) return;
  const int row = static_cast<int>(e % L.mpad);
  const int j = static_cast<int>((e / L.mpad) % P);
  const int c = static_cast<int>(e / (static_cast<long long>(L.mpad) * P));
  const int gg = row & 7, rh = (row >> 3) & 1;
  uint32_t* fb = reinterpret_cast<uint32_t*>(ws + L.xfrag) +
                 (static_cast<size_t>((row >> 4) * chunks + c) * P + j) * 256;
  const float4* src = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * K + j * kp + c * KS);
  float sum = 0.f;
#pragma unroll
  for (int cc = 0; cc < KS / 4; ++cc) {
    uint32_t lo = 0, hi = 0;
    if (row < M) {
      const float4 v = __ldg(src + cc);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v.z, v.w);
      sum = __fadd_rn(sum, __low2float(l2));
      sum = __fadd_rn(sum, __high2float(l2));
      sum = __fadd_rn(sum, __low2float(h2));
      sum = __fadd_rn(sum, __high2float(h2));
      lo = bf16x2_bits(l2);
      hi = bf16x2_bits(h2);
    }
    // k = 4cc (pair lo) and 4cc + 2 (pair hi): half k / 16, kk = k % 16,
    // lane 4 * gg + (kk % 8) / 2, register rh + 2 * (kk / 8).
    const int k_lo = 4 * cc, k_hi = 4 * cc + 2;
    fb[((k_lo >> 4) * 32 + gg * 4 + ((k_lo & 7) >> 1)) * 4 + rh + 2 * ((k_lo & 15) >> 3)] = lo;
    fb[((k_hi >> 4) * 32 + gg * 4 + ((k_hi & 7) >> 1)) * 4 + rh + 2 * ((k_hi & 15) >> 3)] = hi;
  }
  ws[L.xs + static_cast<size_t>(j * chunks + c) * L.mpad + row] = sum;
}

template <int P, int NT, int WM, int WN>
struct Tile {
  static constexpr int BM = 16 * WM;
  static constexpr int BN = 8 * NT * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int BNP = BN + BPAD;                  // staged weight row pitch (bytes)
  static constexpr int W_BYTES = KS * BNP;               // weight rows of a slot
  static constexpr int A_WORDS = WM * P * 256;           // x fragments of a slot
  static constexpr int SZ_FLOATS = P * 2 * BN + P * BM;  // scales, zeros, then x chunk sums
  static constexpr int SLOT = W_BYTES + A_WORDS * 4 + SZ_FLOATS * 4;
  static constexpr int SMEM = NSTAGE * SLOT;
  static_assert(BM * BN * 4 <= SMEM, "the partial tile reuses the ring");
};

template <int P, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
packed_mma_kernel(const Args a) {
  using T = Tile<P, NT, WM, WN>;
  constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS, BNP = T::BNP;
  constexpr int BITS = 8 / P;
  constexpr uint32_t MASK = ((1u << BITS) - 1u) * 0x00010001u;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, part = blockIdx.z;
  const int M = a.M, K = a.K, N = a.N, block = a.block;
  const Layout L(M, K);
  const int nbk = K / P / block;
  const uint32_t* xfrag = reinterpret_cast<const uint32_t*>(a.ws + L.xfrag);
  const float* xs = a.ws + L.xs;
  const int kp = K / P, chunks = kp / KS;
  const int b_lo = static_cast<int>(static_cast<long long>(part) * nbk / a.S);
  const int b_hi = static_cast<int>(static_cast<long long>(part + 1) * nbk / a.S);
  const int kbeg = b_lo * block;
  const int nstage = (b_hi - b_lo) * block / KS;
  const int per_block = block / KS;
  const bool w16 = (N & 15) == 0;  // weight rows 16-byte aligned: cp.async
  const bool s16 = (N & 3) == 0;   // scale rows 16-byte aligned

  // Stage st into ring slot st % NSTAGE, in two halves: what the weights
  // give (their rows and, if the stage ends a scale block, that block's
  // scales and zeros), and what stage_x_kernel gives (the x fragments and
  // chunk sums). The caller commits.
  auto fetch_w = [&](int st) {
    if (st >= nstage) return;
    unsigned char* slot = smem + (st % NSTAGE) * T::SLOT;
    const int r0 = kbeg + st * KS;
    constexpr int CH = BN / 16;
    for (int e = tid; e < KS * CH; e += THREADS) {
      const int r = e / CH, c = (e % CH) * 16, gn = n0 + c;
      const uint8_t* src = a.q + static_cast<size_t>(r0 + r) * N + gn;
      uint8_t* dst = slot + r * BNP + c;
      if (w16) {
        cp_async16(dst, gn < N ? src : a.q, gn < N ? 16 : 0);
      } else {
#pragma unroll 1
        for (int b = 0; b < 16; ++b) dst[b] = gn + b < N ? src[b] : 0;
      }
    }
    if ((st + 1) % per_block == 0) {
      const int b = b_lo + st / per_block;
      float* sdst = reinterpret_cast<float*>(slot + T::W_BYTES + T::A_WORDS * 4);
      constexpr int FCH = BN / 4;
      for (int e = tid; e < P * 2 * FCH; e += THREADS) {
        const int row = e / FCH, c = (e % FCH) * 4, gn = n0 + c;  // row = 2 * plane + (zero?)
        const float* base = (row & 1) ? a.zero : a.scale;
        const float* src = base + static_cast<size_t>((row >> 1) * nbk + b) * N + gn;
        float* dst = sdst + row * BN + c;
        if (s16) {
          cp_async16(dst, gn < N ? src : base, gn < N ? 16 : 0);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) dst[i] = gn + i < N ? src[i] : 0.f;
        }
      }
    }
  };
  auto fetch_x = [&](int st) {
    if (st >= nstage) return;
    unsigned char* slot = smem + (st % NSTAGE) * T::SLOT;
    const int c0 = (kbeg + st * KS) / KS;
    constexpr int ACH = P * 64;  // 16-byte chunks of one m16 tile's stage
    uint32_t* adst = reinterpret_cast<uint32_t*>(slot + T::W_BYTES);
    for (int e = tid; e < WM * ACH; e += THREADS) {
      const int mt = e / ACH, off = (e % ACH) * 4, mtg = m0 / 16 + mt;
      const uint32_t* src = xfrag + static_cast<size_t>(mtg * chunks + c0) * P * 256 + off;
      cp_async16(adst + mt * P * 256 + off, mtg < L.mt ? src : xfrag, mtg < L.mt ? 16 : 0);
    }
    float* xdst = reinterpret_cast<float*>(slot + T::W_BYTES + T::A_WORDS * 4) + P * 2 * BN;
    constexpr int XCH = BM / 4;
    for (int e = tid; e < P * XCH; e += THREADS) {
      const int j = e / XCH, c = (e % XCH) * 4;
      const float* src = xs + static_cast<size_t>(j * chunks + c0) * L.mpad + m0 + c;
      const bool ok = m0 + c < L.mpad;
      cp_async16(xdst + j * BM + c, ok ? src : xs, ok ? 16 : 0);
    }
  };

  float acc[NT][4];
  float p[P][NT][4];
  float xsum[P][2];  // rows g and g + 8: sums of x16 over the scale block so far
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[j][i][c] = 0.f;

  // The weights do not depend on stage_x_kernel, which this kernel may
  // overlap (programmatic dependent launch): their first stages go out
  // before the wait for it.
  for (int s = 0; s < NSTAGE - 1; ++s) fetch_w(s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int s = 0; s < NSTAGE - 1; ++s) {
    fetch_x(s);
    cp_async_commit();
  }

  for (int st = 0; st < nstage; ++st) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    fetch_w(st + NSTAGE - 1);
    fetch_x(st + NSTAGE - 1);
    cp_async_commit();

    const unsigned char* slot = smem + (st % NSTAGE) * T::SLOT;
    const float* sz = reinterpret_cast<const float*>(slot + T::W_BYTES + T::A_WORDS * 4);
    const bool fresh = st % per_block == 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {  // chunk sums, added in k order
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const float v = sz[P * 2 * BN + j * BM + wm * 16 + g + 8 * rh];
        xsum[j][rh] = fresh ? v : __fadd_rn(xsum[j][rh], v);
      }
    }
    const uint8_t* wsrc = slot + wn * 8 * NT + NT * g;
    const uint32_t* fa = reinterpret_cast<const uint32_t*>(slot + T::W_BYTES) + wm * P * 256 + lane * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
      const int rows[4] = {h * 16 + 2 * t, h * 16 + 2 * t + 1, h * 16 + 2 * t + 8, h * 16 + 2 * t + 9};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (NT == 4) {
          w[r] = *reinterpret_cast<const uint32_t*>(wsrc + rows[r] * BNP);
        } else {
          w[r] = *reinterpret_cast<const uint16_t*>(wsrc + rows[r] * BNP);
        }
      }
      // tile i: byte i of the rows (2t, 2t+1) and (2t+8, 2t+9) into the low
      // bytes of the two 16-bit halves (the other bytes are masked later).
      uint32_t lo[NT], hi[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
        lo[i] = prmt(w[0], w[1], sel);
        hi[i] = prmt(w[2], w[3], sel);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const uint4 af = *reinterpret_cast<const uint4*>(fa + (j * 2 + h) * 128);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          mma_bf16(p[j][i], af, raw_to_bf16x2(lo[i] >> (BITS * j), MASK),
                   raw_to_bf16x2(hi[i] >> (BITS * j), MASK));
        }
      }
    }

    if ((st + 1) % per_block == 0) {  // the scale block ends: fold every plane, in order
      sz += wn * 8 * NT + 2 * NT * t;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float xg = xsum[j][0], xg8 = xsum[j][1];
        const float* sp = sz + 2 * j * BN;
        const float* zp = sp + BN;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float s0 = sp[i], s1 = sp[NT + i];
          const float zs0 = __fmul_rn(zp[i], s0), zs1 = __fmul_rn(zp[NT + i], s1);
          acc[i][0] = __fadd_rn(acc[i][0], __fsub_rn(__fmul_rn(p[j][i][0], s0), __fmul_rn(xg, zs0)));
          acc[i][1] = __fadd_rn(acc[i][1], __fsub_rn(__fmul_rn(p[j][i][1], s1), __fmul_rn(xg, zs1)));
          acc[i][2] = __fadd_rn(acc[i][2], __fsub_rn(__fmul_rn(p[j][i][2], s0), __fmul_rn(xg8, zs0)));
          acc[i][3] = __fadd_rn(acc[i][3], __fsub_rn(__fmul_rn(p[j][i][3], s1), __fmul_rn(xg8, zs1)));
#pragma unroll
          for (int c = 0; c < 4; ++c) p[j][i][c] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

  // C registers 0, 1 are row g, columns 2t and 2t+1 of tile i: slab columns
  // 2*NT*t + i and 2*NT*t + NT + i; registers 2, 3 the same for row g + 8.
  const int col0 = wn * 8 * NT + 2 * NT * t;  // in the tile
  if (a.S == 1) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int gm = m0 + wm * 16 + g + 8 * rh;
      if (gm >= M) continue;
      float v[2 * NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        v[i] = acc[i][2 * rh];
        v[NT + i] = acc[i][2 * rh + 1];
      }
      float* o = a.out + static_cast<size_t>(gm) * N + n0 + col0;
      if (s16 && n0 + col0 + 2 * NT <= N) {
#pragma unroll
        for (int c = 0; c < 2 * NT; c += 4)
          *reinterpret_cast<float4*>(o + c) = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 2 * NT; ++c)
          if (n0 + col0 + c < N) o[c] = v[c];
      }
    }
    return;
  }

  // Split K: the S parts of a tile are one thread block cluster. Each puts
  // its partial tile in its own shared memory; then part r adds, for its
  // share of the tile, the partials of parts 0..S-1 in that order, read
  // across the cluster (distributed shared memory).
  cg::cluster_group cluster = cg::this_cluster();
  float* tile = reinterpret_cast<float*>(smem);
  __syncthreads();  // the ring is free
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float* row = tile + (wm * 16 + g + 8 * rh) * BN + col0;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      row[i] = acc[i][2 * rh];
      row[NT + i] = acc[i][2 * rh + 1];
    }
  }
  cluster.sync();
  const int share = (BM * BN + a.S - 1) / a.S;
  const int e_end = min(BM * BN, (part + 1) * share);
  for (int e = part * share + tid; e < e_end; e += THREADS) {
    const int gm = m0 + e / BN, gn = n0 + e % BN;
    if (gm >= M || gn >= N) continue;
    float sum = *cluster.map_shared_rank(tile + e, 0);
    for (int r = 1; r < a.S; ++r) sum = __fadd_rn(sum, *cluster.map_shared_rank(tile + e, r));
    a.out[static_cast<size_t>(gm) * N + gn] = sum;
  }
  cluster.sync();  // no part leaves while another still reads its tile
}

template <int P, int NT, int WM, int WN>
cudaError_t launch_tile(const Args& a, cudaStream_t st) {
  using T = Tile<P, NT, WM, WN>;
  auto kernel = packed_mma_kernel<P, NT, WM, WN>;
  static SmemLimit limit;
  const cudaError_t attr = limit.ensure(kernel, T::SMEM);
  if (attr != cudaSuccess) return attr;
  const long long threads = static_cast<long long>(Layout(a.M, a.K).mpad) * (a.K / KS);
  stage_x_kernel<P><<<static_cast<int>((threads + 127) / 128), 128, 0, st>>>(a.x, a.ws, a.M, a.K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + T::BN - 1) / T::BN, (a.M + T::BM - 1) / T::BM, a.S);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;  // the S parts of a tile
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = a.S;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The bf16-mode call: the tile (bn, bm) and split count S come from the
// wrapper's plan (S at most MAX_SPLIT, the portable cluster size), and
// a.ws is a workspace of Layout(M, K).total words.
// Returns a CUDA error code, cudaErrorInvalidValue for a plan this file has
// no kernel for.
template <int P>
int launch_bf16(const Args& a, int bn, int bm, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  if (a.S < 1 || a.S > MAX_SPLIT || a.ws == nullptr || a.block % KS) return static_cast<int>(err);
  if (bm == 16) {
    if (bn == 16) err = launch_tile<P, 2, 1, 1>(a, st);
    else if (bn == 32) err = launch_tile<P, 4, 1, 1>(a, st);
    else if (bn == 64) err = launch_tile<P, 4, 1, 2>(a, st);
    else if (bn == 128) err = launch_tile<P, 4, 1, 4>(a, st);
  } else if (bm == 64) {
    if (bn == 16) err = launch_tile<P, 2, 4, 1>(a, st);
    else if (bn == 32) err = launch_tile<P, 4, 4, 1>(a, st);
    else if (bn == 64) err = launch_tile<P, 4, 4, 2>(a, st);
  } else if (bm == 32 && bn == 128) {
    err = launch_tile<P, 4, 2, 4>(a, st);
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace packed
