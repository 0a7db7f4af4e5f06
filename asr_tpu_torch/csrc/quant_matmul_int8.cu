// Int8 weight-only dequant-fused matmul for Hopper (sm_90a).
//
//   out[m, n] = sum_k x'[m, k] * (q[k, n] - zero[k / block, n]) * scale[k / block, n]
//
// x (M, K) f32 row-major; q (K, N) int8 row-major, stored centered (q - 128);
// scale, zero (K / block, N) f32, zero centered (zero - 128); out (M, N) f32.
// x' = x, or x rounded to bf16 (round to nearest even) in the "bf16" mode.
//
// Replaces the Pallas TPU kernel asr_tpu/ops/quant_matmul.py:_kernel
// (quant_matmul_pallas). The two modes keep that kernel's two formulations:
//
// bf16 mode (every serving path): tensor cores. The raw centered integers
// (-128..127, exact in bf16) are the B operand of mma.sync m16n8k16 (bf16
// in, f32 accumulate), so the weight is never rounded. For each scale
// block b:
//   p  = sum over the block's k of x16 * q      (tensor cores, f32)
//   xs = sum over the block's k of x16          (f32)
//   acc += p * s - xs * (z * s)                  (f32: two fused multiply-adds)
// A first kernel (stage_x_kernel) rounds x to bf16 once and writes it in
// mma fragment order with per-row chunk sums (xs); the matmul kernel starts
// beside it (programmatic dependent launch), issues its first weight
// stages, then waits for x. Each scale block is padded with zero rows to a
// multiple of the stage (KS = 64 rows: K = block = 560 runs 9 stages, 140
// runs 3), so a stage never straddles two blocks. Stages stream through a
// ring of NSTAGE slots in dynamic shared memory: weight rows by 16-byte
// cp.async where N is a multiple of 16 (else by bytes through registers,
// loaded a ring's depth ahead and stored after the stage's math), the x
// fragments and chunk sums of the block's m16 tiles, and, in the slot of a
// scale block's last stage, its scales and zeros.
//
// f32 mode (the exact replays): the CUDA-core kernel at the end of this
// file, unchanged from its first design: each block owns a 64 x 64 output
// tile, dequantizes the weight in registers as it stages it, and keeps
// one fmaf chain per output over k.
//
// Sum order and schedule. The wrapper's plan (ops/quant_matmul.py,
// int8_plan) splits the K / block scale blocks into V contiguous equal
// parts, V from (K, N, block) alone. Each output is
//   ((part_0 + part_1) + ...) + part_{V-1},
// each part folded block by block from 0, the k16 steps of a block in
// order. How the parts are computed follows M:
//   M <= 16 and mid M: the V parts of a 16 x BN or 64 x 128 tile are V
//     blocks of one thread block cluster; each folds its part and the parts
//     add in rank order through distributed shared memory. No float atomics.
//   large M: one block walks its 64 x 128 or 64 x 64 tile's V parts in
//     order, the part in registers and the total of the parts so far in
//     shared memory; it owns the whole of K, so no partial leaves the block.
// Every output element is one row of A against one column of B, and its
// place in the m16 and n8 tiles does not change mma.sync's result (checked
// bitwise across every tile on the card: chip_smoke.py phase 3, the card
// tests), so a row of a batched call is bitwise the row alone, whatever
// tile and schedule the plan picks for that M.
//
// Weight fragments. A warp owns MT m16 tiles and NT n8 tiles of an 8 * NT
// column slab, whose column NT * g + i is column g of n8 tile i. mma's B
// fragment wants, for column g = lane / 4, the k pairs (2t, 2t+1) and
// (2t+8, 2t+9), t = lane % 4: a thread reads one NT-byte word (NT
// neighbouring columns) from each of those four staged rows, gathers a
// column's two bytes with one prmt per tile and k pair, and makes two
// exact bf16 of two signed bytes with two lop3 and one bf16x2 add:
// 128 + (q & 0x7F) by its mantissa bits, plus -(128 + (q & 0x80)). A
// fragment is built once per k16 step and reused by the warp's MT m16 tiles.
//
// What bounds it on an H100 (3.35 TB/s; bf16 tensor cores 989 TFLOP/s): a
// call does 2*M*K*N operations and moves K*N weight bytes, 8*K*N/block
// scale and zero bytes and 4*(M*K + M*N) activation bytes. The encoder and
// tower linears (M = 416 .. 1500) are ~230-440 operations per byte, about
// the ridge (295); the heads and decode steps (M = 1..8) 2-16, bytes bound.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, device
// time of a CUDA graph): the M = 1500 encoder linears at 136-152 TFLOP/s
// (cuBLAS on bf16 weights: 500-700), the q2 head (166 MB) at M = 1 in
// 0.070 ms (2.4 TB/s), a decode call at M = 1..2 in 8-12 us. At large M
// the mma pipe is ~15 % busy: in development runs, taking any one part out
// of the main loop (the mma, the fragment conversion, the fold, either
// copy) moved its time only a little, so the loop is bound by its
// instruction stream and latency at two warps a scheduler rather than by
// one resource; a warp-specialized producer / consumer loop is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "packed_common.cuh"

// Internal linkage (the anonymous namespace): with two libraries of this
// design loaded in one process, an externally visible launch_tile would be
// shared between them, and with it its "attribute already set" static, so
// the second library's kernel would never get its shared-memory limit.
namespace i8 {
namespace {

namespace cg = cooperative_groups;
using packed::bf16x2_bits;
using packed::cp_async16;
using packed::cp_async_commit;
using packed::cp_async_wait;
using packed::mma_bf16;
using packed::prmt;

constexpr int KS = 64;        // padded rows of K a pipeline stage holds (four k16 steps)
constexpr int NSTAGE = 4;     // depth of the ring
constexpr int BPAD = 16;      // padding bytes after each staged weight row
constexpr int MAX_SPLIT = 8;  // parts of a tile: one thread block cluster, at most the portable size

struct Args {
  const float* x;
  const int8_t* q;
  const float* scale;
  const float* zero;
  float* out;  // (M, N)
  float* ws;   // workspace, see Layout
  int M, K, N, block, V;
};

// Workspace layout (f32 words), mirrored by the wrapper's int8_workspace:
// x in bf16 fragment order over the padded K axis (kp = K / block scale
// blocks of bp rows, Mpad * kp / 2 words), then the per-row sums of each
// KS-row chunk of rounded values (kp / KS rows of Mpad).
struct Layout {
  int mt, mpad, nbk, bp, kp;
  size_t xs, total;
  __host__ __device__ Layout(int M, int K, int block) {
    mt = (M + 15) / 16;
    mpad = 16 * mt;
    nbk = K / block;
    bp = (block + KS - 1) / KS * KS;
    kp = nbk * bp;
    xs = static_cast<size_t>(mpad) * kp / 2;
    total = xs + static_cast<size_t>(kp / KS) * mpad;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(packed::smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

// mma with a zero accumulator: the first k16 step of a scale block.
__device__ __forceinline__ void mma_bf16_first(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f));
}

// x (M, K) f32 -> bf16 (nearest even) in mma A-fragment order,
// [m16 tile][kp / 16 k16 steps][lane][4 registers], padded rows and the rows
// M..Mpad-1 zero, and the row sum of each chunk of KS padded k. One thread
// per (m16 tile, chunk, lane) writes the lane's registers of the chunk's
// k16 steps, 16 bytes each; the four lanes of a row pair add their sums in a
// fixed tree.
__global__ void stage_x_kernel(const float* __restrict__ x, float* __restrict__ ws, int M, int K,
                               int block) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Layout L(M, K, block);
  const int chunks = L.kp / KS;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const bool live = e < static_cast<long long>(L.mt) * chunks * 32;
  const int lane = static_cast<int>(e & 31);
  const long long w = e >> 5;  // (m16 tile, chunk)
  const int mt = live ? static_cast<int>(w / chunks) : 0, c = live ? static_cast<int>(w % chunks) : 0;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {mt * 16 + g, mt * 16 + g + 8};
  const int b = c * KS / L.bp, o0 = c * KS % L.bp;  // the chunk's scale block and first padded row in it
  // Two values of row r at padded k o, o + 1 of block b, zero past the block's end or the rows.
  auto pair = [&](int r, int o) {
    float v0 = 0.f, v1 = 0.f;
    if (live && r < M && o < block) {
      const float* src = x + static_cast<size_t>(r) * K + static_cast<size_t>(b) * block + o;
      if (o + 1 < block && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(src));
        v0 = f.x;
        v1 = f.y;
      } else {
        v0 = __ldg(src);
        if (o + 1 < block) v1 = __ldg(src + 1);
      }
    }
    return __floats2bfloat162_rn(v0, v1);
  };
  float sum[2] = {0.f, 0.f};
  uint4* dst = reinterpret_cast<uint4*>(ws) +
               (static_cast<size_t>(mt) * (L.kp / 16) + c * (KS / 16)) * 32 + lane;
#pragma unroll
  for (int h = 0; h < KS / 16; ++h) {
    const int o = o0 + h * 16 + 2 * t;
    // registers 0..3: (row g, k 2t), (row g + 8, k 2t), (row g, k 2t + 8), (row g + 8, k 2t + 8)
    __nv_bfloat162 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = pair(rows[i & 1], o + 8 * (i >> 1));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sum[i & 1] = __fadd_rn(sum[i & 1], __low2float(v[i]));
      sum[i & 1] = __fadd_rn(sum[i & 1], __high2float(v[i]));
    }
    if (live)
      dst[h * 32] = make_uint4(bf16x2_bits(v[0]), bf16x2_bits(v[1]), bf16x2_bits(v[2]), bf16x2_bits(v[3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
    sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
  }
  if (live && t == 0) {
    ws[L.xs + static_cast<size_t>(c) * L.mpad + rows[0]] = sum[0];
    ws[L.xs + static_cast<size_t>(c) * L.mpad + rows[1]] = sum[1];
  }
}

// Two signed bytes (the low byte of each 16-bit half of v) -> two bf16,
// exactly: 128 + (q & 0x7F) by its mantissa bits, plus -(128 + (q & 0x80)).
__device__ __forceinline__ uint32_t s8_to_bf16x2(uint32_t v) {
  uint32_t lo7, neg;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(lo7) : "r"(v), "r"(0x007F007Fu), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(neg) : "r"(v), "r"(0x00800080u), "r"(0xC300C300u));
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo7), "r"(0x3F803F80u), "r"(neg));
  return r;
}

template <int MT, int NT, int WM, int WN>
struct Tile {
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 8 * NT * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int BNP = BN + BPAD;             // staged weight row pitch (bytes)
  static constexpr int W_BYTES = KS * BNP;          // weight rows of a slot
  static constexpr int A_WORDS = (BM / 16) * KS * 8;  // x fragments of a slot: KS / 16 k16 steps a m16 tile
  static constexpr int SZ_FLOATS = 2 * BN + BM;     // scales, zeros, then x chunk sums
  static constexpr int SLOT = W_BYTES + A_WORDS * 4 + SZ_FLOATS * 4;
  static constexpr int RING = NSTAGE * SLOT;
  static_assert(SLOT % 16 == 0, "slots stay 16-byte aligned");
};

// A warp owns MT m16 tiles and NT n8 tiles: 16 * MT rows of an 8 * NT
// column slab, whose column NT * g + i is column g of n8 tile i. WALK: one
// block walks the tile's V parts (grid z = 1), the total of the parts so far
// in shared memory after the ring; else block z folds part z and the V
// blocks of a tile are one cluster. W16: N % 16 == 0, the weight rows go by
// cp.async.
template <int MT, int NT, int WM, int WN, bool WALK, bool W16>
__global__ void __launch_bounds__(32 * WM * WN, 1)
int8_mma_kernel(const Args a) {
  using T = Tile<MT, NT, WM, WN>;
  constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS, BNP = T::BNP;
  constexpr int CH = BN / 16;                        // 16-byte chunks of a staged weight row
  static_assert(WALK || BM * BN * 4 <= T::RING, "the partial tile reuses the ring");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = a.M, N = a.N, block = a.block;
  const Layout L(M, a.K, block);
  const int per_block = L.bp / KS;   // stages of a scale block
  const int per_part = L.nbk / a.V;  // scale blocks of a part
  const int b_lo = WALK ? 0 : static_cast<int>(blockIdx.z) * per_part;
  const int nstage = (WALK ? L.nbk : per_part) * per_block;
  const uint32_t* xfrag = reinterpret_cast<const uint32_t*>(a.ws);
  const float* xs = a.ws + L.xs;
  const bool s16 = (N & 3) == 0;  // scale rows 16-byte aligned

  // Stage st holds padded rows [o0, o0 + KS) of scale block b, o0 = sb * KS
  // (rows o0 + r >= block are zeros); the fetches take (st, b, sb). Each
  // thread's copies sit at fixed offsets from a per-stage base, unrolled.
  auto slot_of = [&](int st) { return smem + (st % NSTAGE) * T::SLOT; };
  constexpr int WSTEP = THREADS / CH;  // weight rows between a thread's chunks
  static_assert(THREADS % CH == 0 && KS % WSTEP == 0, "whole weight rows per pass");
  const int wr0 = tid / CH, wgn = n0 + (tid % CH) * 16;
  const bool wcol = wgn < N;
  const size_t wstride = static_cast<size_t>(WSTEP) * N;
  auto fetch_w = [&](int st, int b, int sb) {  // W16: the weight rows by cp.async
    if (st >= nstage) return;
    unsigned char* dst = slot_of(st) + wr0 * BNP + (tid % CH) * 16;
    const int o0 = sb * KS + wr0;
    const int8_t* src = a.q + (static_cast<size_t>(b) * block + o0) * N + wgn;
#pragma unroll
    for (int j = 0; j < KS / WSTEP; ++j) {
      const bool ok = wcol && o0 + j * WSTEP < block;
      cp_async16(dst + j * WSTEP * BNP, ok ? src + j * wstride : a.q, ok ? 16 : 0);
    }
  };
  struct Chunks {
    uint4 v[KS / WSTEP];
  };
  auto load_w = [&](int st, int b, int sb) {  // !W16: this thread's chunks, byte by byte
    Chunks ch;
    const int o0 = sb * KS + wr0;
    const int8_t* src = a.q + (static_cast<size_t>(b) * block + o0) * N + wgn;
#pragma unroll
    for (int j = 0; j < KS / WSTEP; ++j) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (st < nstage && o0 + j * WSTEP < block) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (wgn + i < N)
            w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j * wstride + i)))
                         << (8 * (i & 3));
      }
      ch.v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return ch;
  };
  auto store_w = [&](int st, const Chunks& ch) {
    if (st >= nstage) return;
    unsigned char* dst = slot_of(st) + wr0 * BNP + (tid % CH) * 16;
#pragma unroll
    for (int j = 0; j < KS / WSTEP; ++j) *reinterpret_cast<uint4*>(dst + j * WSTEP * BNP) = ch.v[j];
  };
  // a scale block's scales and zeros, in the slot of its last stage
  auto fetch_sz = [&](int st, int b, int sb) {
    if (st >= nstage || sb != per_block - 1) return;
    float* sdst = reinterpret_cast<float*>(slot_of(st) + T::W_BYTES + T::A_WORDS * 4);
    constexpr int FCH = BN / 4;
#pragma unroll
    for (int j = 0; j < (2 * FCH + THREADS - 1) / THREADS; ++j) {
      const int e = tid + j * THREADS;
      if (2 * FCH % THREADS && e >= 2 * FCH) break;
      const int row = e / FCH, c = (e % FCH) * 4, gn = n0 + c;  // row 0: scales, 1: zeros
      const float* base = row ? a.zero : a.scale;
      const float* src = base + static_cast<size_t>(b) * N + gn;
      float* dst = sdst + row * BN + c;
      if (s16) {
        cp_async16(dst, gn < N ? src : base, gn < N ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) cp_async4(dst + i, gn + i < N ? src + i : base, gn + i < N ? 4 : 0);
      }
    }
  };
  constexpr int XCH = KS * 2;  // 16-byte chunks of one m16 tile's x fragments in a stage
  static_assert((BM / 16) * XCH % THREADS == 0 && BM / 4 <= THREADS, "whole x chunks per pass");
  const size_t xtile = static_cast<size_t>(L.kp) * 8;  // words of one m16 tile's fragments
  auto fetch_x = [&](int st) {  // what stage_x_kernel gives: x fragments and chunk sums
    if (st >= nstage) return;
    unsigned char* slot = slot_of(st);
    const int c0 = b_lo * per_block + st;  // padded chunk
    uint32_t* adst = reinterpret_cast<uint32_t*>(slot + T::W_BYTES);
    const uint32_t* src = xfrag + static_cast<size_t>(c0) * (KS * 8);
#pragma unroll
    for (int j = 0; j < (BM / 16) * XCH / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int mt = e / XCH, off = (e % XCH) * 4, mtg = m0 / 16 + mt;
      cp_async16(adst + mt * (KS * 8) + off, mtg < L.mt ? src + mtg * xtile + off : xfrag,
                 mtg < L.mt ? 16 : 0);
    }
    if (tid < BM / 4) {
      const int c = tid * 4;
      const bool ok = m0 + c < L.mpad;
      float* xdst = reinterpret_cast<float*>(slot + T::W_BYTES + T::A_WORDS * 4) + 2 * BN;
      cp_async16(xdst + c, ok ? xs + static_cast<size_t>(c0) * L.mpad + m0 + c : xs, ok ? 16 : 0);
    }
  };

  float p[MT][NT][4];    // the scale block's x16 . q
  float acc[MT][NT][4];  // the part, folded block by block
  float xsum[MT][2];     // rows g and g + 8 of each m16 tile: sums of x16 over the block so far
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;

  // The weights do not depend on stage_x_kernel, which this kernel may
  // overlap (programmatic dependent launch): their first stages go out
  // before the wait for it.
  int fb = b_lo, fsb = 0;  // scale block and stage within it of the next stage to fetch
  auto advance = [&]() {
    if (++fsb == per_block) {
      fsb = 0;
      ++fb;
    }
  };
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if constexpr (W16) {
      fetch_w(s, fb, fsb);
    } else {
      store_w(s, load_w(s, fb, fsb));
    }
    fetch_sz(s, fb, fsb);
    advance();
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int s = 0; s < NSTAGE - 1; ++s) {
    fetch_x(s);
    cp_async_commit();
  }

  // The four k16 steps of a stage; kFirst: the stage opens a scale block.
  auto stage_math = [&](const unsigned char* slot, auto first) {
    constexpr bool kFirst = decltype(first)::value;
    const uint8_t* wsrc = slot + wn * 8 * NT + NT * g;
    const uint32_t* fa =
        reinterpret_cast<const uint32_t*>(slot + T::W_BYTES) + wm * MT * (KS * 8) + lane * 4;
#pragma unroll
    for (int h = 0; h < KS / 16; ++h) {
      // rows (2t, 2t+1) and (2t+8, 2t+9) of the step; byte i of a row's word is column g of n8 tile i
      const uint8_t* rsrc = wsrc + (h * 16 + 2 * t) * BNP;
      auto word = [&](int r) -> uint32_t {
        if constexpr (NT == 4) {
          return *reinterpret_cast<const uint32_t*>(rsrc + r * BNP);
        } else {
          return *reinterpret_cast<const uint16_t*>(rsrc + r * BNP);
        }
      };
      const uint32_t w0 = word(0), w1 = word(1), w2 = word(8), w3 = word(9);
      uint32_t b0[NT], b1[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
        b0[i] = s8_to_bf16x2(prmt(w0, w1, sel));
        b1[i] = s8_to_bf16x2(prmt(w2, w3, sel));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 af = *reinterpret_cast<const uint4*>(fa + mt * (KS * 8) + h * 128);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (kFirst && h == 0) {
            mma_bf16_first(p[mt][i], af, b0[i], b1[i]);
          } else {
            mma_bf16(p[mt][i], af, b0[i], b1[i]);
          }
        }
      }
    }
  };

  // WALK: the parts so far, element j of thread tid at j * THREADS + tid
  float* total = reinterpret_cast<float*>(smem + T::RING);
  // the thread's 2 * NT output columns in the tile: C registers 0, 1 of n8
  // tile i are slab columns 2 * NT * t + i and 2 * NT * t + NT + i
  const int col0 = wn * 8 * NT + 2 * NT * t;
  int sb = 0, done = 0;  // stage st's place in its scale block; scale blocks folded so far
  for (int st = 0; st < nstage; ++st) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    [[maybe_unused]] Chunks wnext;
    if constexpr (W16) {
      fetch_w(st + NSTAGE - 1, fb, fsb);
    } else {
      wnext = load_w(st + NSTAGE - 1, fb, fsb);
    }
    fetch_sz(st + NSTAGE - 1, fb, fsb);
    fetch_x(st + NSTAGE - 1);
    cp_async_commit();
    advance();

    const unsigned char* slot = slot_of(st);
    const float* sz = reinterpret_cast<const float*>(slot + T::W_BYTES + T::A_WORDS * 4);
    const bool fresh = sb == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {  // chunk sums, added in k order
        const float v = sz[2 * BN + (wm * MT + mt) * 16 + g + 8 * rh];
        xsum[mt][rh] = fresh ? v : __fadd_rn(xsum[mt][rh], v);
      }
    if (fresh) {
      stage_math(slot, std::true_type{});
    } else {
      stage_math(slot, std::false_type{});
    }
    if constexpr (!W16) store_w(st + NSTAGE - 1, wnext);

    if (++sb == per_block) {  // the scale block ends: acc += p * s - xs * (z * s)
      sb = 0;
      ++done;
      const float* sp = sz + col0;
      const float* zp = sp + BN;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float s0 = sp[i], s1 = sp[NT + i];
        const float zs0 = __fmul_rn(zp[i], s0), zs1 = __fmul_rn(zp[NT + i], s1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float xg = xsum[mt][0], xg8 = xsum[mt][1];
          float* c = acc[mt][i];
          c[0] = __fmaf_rn(-xg, zs0, __fmaf_rn(p[mt][i][0], s0, c[0]));
          c[1] = __fmaf_rn(-xg, zs1, __fmaf_rn(p[mt][i][1], s1, c[1]));
          c[2] = __fmaf_rn(-xg8, zs0, __fmaf_rn(p[mt][i][2], s0, c[2]));
          c[3] = __fmaf_rn(-xg8, zs1, __fmaf_rn(p[mt][i][3], s1, c[3]));
        }
      }
      if constexpr (WALK) {
        if (a.V > 1 && done % per_part == 0 && done < L.nbk) {  // a part ends, not the last: total += acc
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NT; ++i)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                float* tp = total + ((mt * NT + i) * 4 + r) * THREADS + tid;
                *tp = done == per_part ? acc[mt][i][r] : __fadd_rn(*tp, acc[mt][i][r]);
                acc[mt][i][r] = 0.f;
              }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (WALK && a.V > 1) {  // the last part: result = total + acc
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mt][i][r] = __fadd_rn(total[((mt * NT + i) * 4 + r) * THREADS + tid], acc[mt][i][r]);
  }
  if (WALK || a.V == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int gm = m0 + (wm * MT + mt) * 16 + g + 8 * rh;
        if (gm >= M) continue;
        float v[2 * NT];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          v[i] = acc[mt][i][2 * rh];
          v[NT + i] = acc[mt][i][2 * rh + 1];
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

  // The V parts of a tile are one thread block cluster. Each puts its part
  // in its own shared memory; then part r adds, for its share of the tile,
  // the parts 0..V-1 in that order, read across the cluster (distributed
  // shared memory).
  cg::cluster_group cluster = cg::this_cluster();
  float* tile = reinterpret_cast<float*>(smem);
  __syncthreads();  // the ring is free
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float* row = tile + ((wm * MT + mt) * 16 + g + 8 * rh) * BN + col0;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        row[i] = acc[mt][i][2 * rh];
        row[NT + i] = acc[mt][i][2 * rh + 1];
      }
    }
  cluster.sync();
  const int part = static_cast<int>(blockIdx.z);
  const int share = (BM * BN + a.V - 1) / a.V;
  const int e_end = min(BM * BN, (part + 1) * share);
  for (int e = part * share + tid; e < e_end; e += THREADS) {
    const int gm = m0 + e / BN, gn = n0 + e % BN;
    if (gm >= M || gn >= N) continue;
    float sum = *cluster.map_shared_rank(tile + e, 0);
    for (int r = 1; r < a.V; ++r) sum = __fadd_rn(sum, *cluster.map_shared_rank(tile + e, r));
    a.out[static_cast<size_t>(gm) * N + gn] = sum;
  }
  cluster.sync();  // no part leaves while another still reads its tile
}

template <int MT, int NT, int WM, int WN, bool WALK, bool W16>
cudaError_t launch_tile(const Args& a, cudaStream_t st) {
  using T = Tile<MT, NT, WM, WN>;
  auto kernel = int8_mma_kernel<MT, NT, WM, WN, WALK, W16>;
  constexpr int smem = T::RING + (WALK ? T::BM * T::BN * 4 : 0);
  static packed::SmemLimit limit;
  const cudaError_t attr = limit.ensure(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const Layout L(a.M, a.K, a.block);
  const long long threads = static_cast<long long>(L.mt) * (L.kp / KS) * 32;
  if (threads > 0) {
    stage_x_kernel<<<static_cast<int>((threads + 255) / 256), 256, 0, st>>>(a.x, a.ws, a.M, a.K, a.block);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int z = WALK ? 1 : a.V;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + T::BN - 1) / T::BN, (a.M + T::BM - 1) / T::BM, z);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;  // the V parts of a tile
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = z;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The tiles the plan may pick (ops/quant_matmul.py: INT8_CLUSTER_TILES and
// INT8_WALK_TILES): warps of 16 x 32 (MT 1, NT 4), 64 x 32 (MT 4, NT 4) or,
// for the 64 x 64 walking tile, 64 x 16 (MT 4, NT 2).
template <bool W16>
cudaError_t launch_plan(const Args& a, int bn, int bm, int walk, cudaStream_t st) {
  if (walk) {
    if (bm == 64 && bn == 128) return launch_tile<4, 4, 1, 4, true, W16>(a, st);
    if (bm == 64 && bn == 64) return launch_tile<4, 2, 1, 4, true, W16>(a, st);
  } else if (bm == 16) {
    if (bn == 32) return launch_tile<1, 4, 1, 1, false, W16>(a, st);
    if (bn == 64) return launch_tile<1, 4, 1, 2, false, W16>(a, st);
    if (bn == 128) return launch_tile<1, 4, 1, 4, false, W16>(a, st);
  } else if (bm == 64 && bn == 128) {
    return launch_tile<4, 4, 1, 4, false, W16>(a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace i8

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, each owns a 4 x 4 sub-tile
constexpr int TM = 4;
constexpr int TN = 4;

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
      xs[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
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

// Launches on `stream` and returns a CUDA error code (0 on success).
// bf16_x != 0: the tensor-core route with the wrapper's plan: `splits` = V
// parts of whole scale blocks (V divides K / block, at most 8), tiles of
// bn x bm, `walk` != 0 for the large-M schedule, and `ws` a workspace laid
// out as i8::Layout; cudaErrorInvalidValue for a plan this file has no
// kernel for. bf16_x == 0: the f32 CUDA-core route, which ignores the plan
// and the workspace. The caller checks shapes, types, contiguity and the
// 16-byte alignment of q, scale and zero, and guarantees K % block == 0.
extern "C" int quant_matmul_int8(const void* x, const void* q, const void* scale, const void* zero,
                                 void* out, void* ws, int M, int K, int N, int block, int bf16_x,
                                 int splits, int bn, int bm, int walk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  const float* zf = static_cast<const float*>(zero);
  float* of = static_cast<float*>(out);
  if (bf16_x) {
    const i8::Args a{xf, qi, sf, zf, of, static_cast<float*>(ws), M, K, N, block, splits};
    const i8::Layout L(M, K, block);
    if (splits < 1 || splits > i8::MAX_SPLIT || L.nbk % splits || ws == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>((N & 15) == 0 ? i8::launch_plan<true>(a, bn, bm, walk, s)
                                          : i8::launch_plan<false>(a, bn, bm, walk, s));
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_int8_kernel<<<grid, THREADS, 0, s>>>(xf, qi, sf, zf, of, M, K, N, block);
  return static_cast<int>(cudaGetLastError());
}
