// The Qwen3 decode step shared by fused_decode.cu (batch 1) and
// fused_decode_multi.cu (B slots) for Hopper (sm_90a): one design, one code
// path for every slot's arithmetic, so a slot of the multi-slot step
// computes, bitwise, what the batch-1 step computes for it alone.
//
// A step is a chain of 7 kernels a layer (+ 1 before the first layer, + 1
// for the head), each launched with programmatic dependent launch
// (cudaLaunchAttributeProgrammaticStreamSerialization): a kernel starts while
// its predecessor drains, and every block runs griddepcontrol.wait before it
// reads or writes anything a kernel of the step produces, then
// griddepcontrol.launch_dependents. Only the matvec does work before the
// wait: its weight and scale copies, which no kernel writes.
//
//   nibble_matvec  q|k|v, o, gate|up, down, the head: the packed-int4
//                  product on tensor cores (below)
//   attn_step      one launch a layer: a thread block cluster per (kv head,
//                  slot) holds its row chunks
//   rms_stage      residual + RMSNorm of one slot row
//
// Staged inputs. Every matvec input is written once a step by the kernel
// that produces it (rms_stage: the RMSNorm output; attn_step: the sum of the
// chunk contexts; the gate|up matvec: SiLU(g) * u), rounded to bf16, in mma
// A-fragment order, with the sum of each 32-value chunk of rounded values.
// Matvec blocks only copy it (16-byte cp.async).
//
// The matvec. out[row, n] for a packed (K/2, N) weight whose low nibble
// holds rows [0, K/2) and high nibble rows [K/2, K), block-128 scales s and
// zero*scale zs in the plane-major (2, K/256, N) layout. Slots are the rows
// of an m16 tile (two tiles above 16 slots), the raw nibbles the B operand of
// mma.sync m16n8k16 (bf16 in, f32 accumulate), so every weight byte is read
// once a step for all slots and feeds both planes. Per 128-row block b
// (plane-major: b = plane * K/256 + j):
//   p_b  = sum over the block's 8 k16 steps of mma(x16, u)          (f32, below)
//   xs_b = the block's four chunk sums, added in k order             (f32)
//   t_b  = p_b * s_b - xs_b * zs_b
//   out  = t_0 + t_1 + ... + t_{nb-1}, in that order.
// p_b is summed by four warps, one a 32-row stage (two k16 steps each), and
// their partial sums are added in stage order. A tile of BN columns is
// split into `parts` runs of at most two whole 128-row blocks (the plan);
// the parts of a tile form a thread block cluster, each sends every term to
// the inbox of the part that sums that output (distributed shared memory),
// and each part adds its outputs' terms in block order. The split, the tile
// and every order depend on (K, N) alone, and mma.sync's result for a row
// does not depend on the other rows of the tile, so a slot's bits never
// depend on the slot count. A block's weights, scales and staged input all
// go out at once as 16-byte cp.async copies, the weights and scales before
// the wait for the kernel before.
//
// Rounding points (the TPU kernels'): matvec inputs bf16, nibbles exact, the
// block affine above in f32; cached-row scores bf16(q * 128^-0.5) . bf16(k),
// the fresh row's score and p * v in f32 from the unrounded q, k, v;
// probabilities rounded to bf16 after the global max and sum; RMSNorms,
// softmax, SiLU and residuals in f32.
//
// Rows of a staged input past the live slot count (the rest of an m16 tile)
// are never written: mma rows are independent, and no live output reads
// them.
#pragma once

#include "aed_common.cuh"
#include "packed_common.cuh"

// Internal linkage: the batch-1 and multi-slot libraries each keep their
// own copy (a function-local static of a template with external linkage
// would be shared between the two once both are loaded).
namespace qwen {
namespace {

using namespace aed;
namespace cg = cooperative_groups;
using packed::cp_async16;
using packed::cp_async_commit;
using packed::cp_async_wait;

constexpr int kQHd = 128;         // Qwen3 head width
constexpr int kGroups = 2;        // q heads per kv head
constexpr int kStage = packed::KS;  // packed rows of a stage: two k16 steps, one warp's share of a block
constexpr int kChunk = 32;        // values a staged chunk sum covers
constexpr int kMaxParts = 8;      // parts of a matvec tile: one cluster of portable size
constexpr int kStagesPerBlock = 4;  // stages of a 128-row block (kBlock / kStage)
constexpr int kMaxBlocksPerPart = 2;  // 128-row blocks a matvec part holds at once
constexpr int kMaxChunks = 8;     // row chunks of an attention: one cluster of portable size
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take on an H100
constexpr int kPlanInts = 14;     // the plan the wrappers pass, see Plan

// The stacked weights of a step (wh, h_s, h_zs null without the head).
struct Weights {
  const float *in_s, *post_s, *qn_s, *kn_s, *fn_s;
  const int8_t *wq, *wo, *wgu, *wd, *wh;
  const float *qkv_s, *qkv_zs, *o_s, *o_zs, *gu_s, *gu_zs, *dn_s, *dn_zs, *h_s, *h_zs;
};

inline Weights make_weights(const void* in_s, const void* post_s, const void* qn_s,
                            const void* kn_s, const void* fn_s, const void* wq, const void* qkv_s,
                            const void* qkv_zs, const void* wo, const void* o_s, const void* o_zs,
                            const void* wgu, const void* gu_s, const void* gu_zs, const void* wd,
                            const void* dn_s, const void* dn_zs, const void* wh, const void* h_s,
                            const void* h_zs) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  return Weights{f(in_s),   f(post_s), f(qn_s),  f(kn_s),   f(fn_s),  i8(wq),   i8(wo),
                 i8(wgu),   i8(wd),    i8(wh),   f(qkv_s),  f(qkv_zs), f(o_s),  f(o_zs),
                 f(gu_s),   f(gu_zs),  f(dn_s),  f(dn_zs),  f(h_s),   f(h_zs)};
}

// ── staged matvec inputs ─────────────────────────────────────────────────

// The staged input of a matvec of depth K for mpad rows (16 or 32): frag,
// mpad * K/2 words of bf16 pairs in the order [m16 tile][chunk c < K/64]
// [plane][k16 half][lane][4 registers] (the mma A fragment of rows 16 mt..,
// k = plane * K/2 + 32 c + 16 half + ..), then sums[(plane * K/64 + c) *
// mpad + row], the sum of the chunk's 32 rounded values.
struct Staged {
  uint32_t* frag;
  float* sums;
  int k, mpad;
  __host__ __device__ static size_t floats(int mpad, int k) {
    return static_cast<size_t>(mpad) * k / 2 + static_cast<size_t>(k / kChunk) * mpad;
  }
  __host__ __device__ Staged(float* base, int mpad_, int k_)
      : frag(reinterpret_cast<uint32_t*>(base)),
        sums(base + static_cast<size_t>(mpad_) * k_ / 2), k(k_), mpad(mpad_) {}
};

// The warp stages the 32 inputs [k0, k0 + 32) of `row`: lane l gives input
// k0 + l, stored rounded to bf16, and the chunk's sum of the rounded values
// (a fixed shuffle tree) goes beside them. Every lane of the warp calls it.
__device__ __forceinline__ void stage_chunk(const Staged& s, int row, int k0, float v) {
  const int lane = threadIdx.x & 31;
  const float r = bf16r(v);
  const int kh = s.k / 2, chunks = kh / kChunk;
  const int plane = k0 >= kh, c = (k0 - plane * kh) / kChunk;
  const int half = lane >> 4, q = lane & 15;
  const int reg = ((row >> 3) & 1) + 2 * (q >> 3);
  const size_t word = (static_cast<size_t>((row >> 4) * chunks + c) * 2 + plane) * 256 +
                      (half * 32 + 4 * (row & 7) + ((q & 7) >> 1)) * 4 + reg;
  reinterpret_cast<__nv_bfloat16*>(s.frag)[2 * word + (q & 1)] = __float2bfloat16_rn(r);
  const float sum = warp_sum(r);
  if (lane == 0) s.sums[static_cast<size_t>(plane * chunks + c) * s.mpad + row] = sum;
}

// ── the matvec ───────────────────────────────────────────────────────────

struct Mv {
  const float* x;       // staged input (Staged layout: mpad rows, depth k)
  const int8_t* w;      // (k/2, n) packed nibbles
  const float* s;       // (2, k/256, n) scales
  const float* zs;      // (2, k/256, n) zero * scale
  int k, n, rows, parts;
  int pair;             // 0: plain; else gate|up of width 2 pair, see nibble_matvec
  float* out;           // plain: out[row * ld + column]
  int ld;
  float* next;          // paired: the down matvec's staged input (depth pair)
};

template <int MT, int WN>
struct MvTile {
  static constexpr int MPAD = 16 * MT;
  static constexpr int BN = 32 * WN;  // WN column slabs of 32: 4 n8 tiles each
  static constexpr int THREADS = 32 * WN * kStagesPerBlock;  // a warp per (slab, stage of a block)
  static constexpr int BNP = BN + packed::BPAD;      // staged weight row pitch (bytes)
  static constexpr int W_BYTES = kStage * BNP;       // weight rows of a stage
  static constexpr int A_WORDS = MT * 2 * 256;       // x fragments of a stage, both planes
  static constexpr int SLOT = W_BYTES + A_WORDS * 4 + 2 * MPAD * 4;  // + the chunk sums
  static constexpr int PSUM = 2 * MT * 16 * 32;  // floats of one warp's partial sums
  static constexpr int XCH = kStagesPerBlock * WN * PSUM;  // the exchange of the stages' partial sums
};

// Output cells a part of a tile sums: the tile's rows * BN cells split into
// `parts` shares, each a multiple of 64 (in the paired order, two whole
// 32-input chunks of g and u).
__host__ __device__ inline int mv_share(int rows, int bn, int parts) {
  const int per = (rows * bn + parts - 1) / parts;
  return (per + 63) / 64 * 64;
}

// Shared memory of a matvec block: its stages (weight rows, x fragments,
// chunk sums), the scales of its 128-row blocks (both planes, s and zs),
// the exchange of the stages' partial sums, then its inbox, the terms of
// every block of K for the cells it sums.
template <int MT, int WN>
size_t mv_smem(int k, int rows, int parts) {
  using T = MvTile<MT, WN>;
  const int nbj = k / 2 / kBlock, jper = nbj / parts;
  return static_cast<size_t>(jper) * kStagesPerBlock * T::SLOT + static_cast<size_t>(jper) * 4 * T::BN * 4 +
         static_cast<size_t>(T::XCH) * 4 + static_cast<size_t>(2 * nbj) * mv_share(rows, T::BN, parts) * 4;
}

// The weight column of tile column c. Plain: tile * BN + c. Paired (the
// gate|up matvec, n = 2 pair): the tile's first BN/2 columns are gate
// columns [tile * BN/2, ..) and the rest the matching up columns pair + ..,
// so one block holds g and u of the same BN/2 inputs of the down matvec.
template <int BN>
__device__ __forceinline__ int mv_column(const Mv& a, int tile, int c) {
  if (a.pair == 0) return tile * BN + c;
  return c < BN / 2 ? tile * (BN / 2) + c : a.pair + tile * (BN / 2) + c - BN / 2;
}

// The cell of (row, tile column c): row-major when plain; paired, the g of
// four neighbouring inputs, then their u: input k = row * BN/2 + c % (BN/2)
// at (k / 4) * 8 + (c >= BN/2) * 4 + k % 4. Either way four neighbouring
// columns of one half are four neighbouring cells.
template <int BN>
__device__ __forceinline__ int mv_cell(const Mv& a, int row, int c) {
  if (a.pair == 0) return row * BN + c;
  const int k = row * (BN / 2) + c % (BN / 2);
  return k / 4 * 8 + (c >= BN / 2) * 4 + k % 4;
}

// grid (parts, n / BN), cluster (parts, 1, 1). Part r of a tile takes the
// packed rows of the 128-row blocks j in [r jper, (r + 1) jper), jper =
// K/256 / parts <= 2 (both planes of each), all in flight at once: the
// weights and scales before the wait for the kernel before, the x
// fragments after. Warp (slab wn, stage ws) sums the mma of stage ws of
// each block over its two k16 steps; the four stages' partial sums are
// added in stage order through shared memory, and warp ws applies the
// block affine to a quarter of the slab's terms. Each block's two terms go, cell by cell, to the inbox
// of the part that sums that cell (distributed shared memory: stores, no
// waiting), and after one cluster barrier every part adds its cells' terms
// in block order. Plain: out[row, :] for the live rows. Paired: SiLU(g) * u
// of the tile's BN/2 inputs, staged into `next`.
template <int MT, int WN>
__global__ void __launch_bounds__(32 * WN * kStagesPerBlock) nibble_matvec(const Mv a) {
  using T = MvTile<MT, WN>;
  constexpr int BN = T::BN, THREADS = T::THREADS, BNP = T::BNP, MPAD = T::MPAD;
  constexpr int SPB = kStagesPerBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, ws = warp / WN;
  const int g = lane >> 2, t = lane & 3;
  const int part = blockIdx.x, tile = blockIdx.y;
  const int n = a.n, kh = a.k / 2, nbj = kh / kBlock, jper = nbj / a.parts, j0 = part * jper;
  const int chunks = kh / kChunk, nstage = jper * SPB;
  const int share = mv_share(a.rows, BN, a.parts);
  const uint32_t* xfrag = reinterpret_cast<const uint32_t*>(a.x);
  const float* xsum = a.x + static_cast<size_t>(MPAD) * a.k / 2;
  float* scl = reinterpret_cast<float*>(smem + static_cast<size_t>(nstage) * T::SLOT);  // [jper][plane][s, zs][BN]
  float* xch = scl + jper * 4 * BN;   // [stage][WN][plane][MT][n8 tile][C register][lane]
  float* inbox = xch + T::XCH;        // [2 nbj blocks][share]

  // The weights and scales do not depend on the kernel before: they go out
  // before the wait for it.
#pragma unroll 1
  for (int e = tid; e < nstage * kStage * (BN / 16); e += THREADS) {
    const int r = e / (BN / 16), c = e % (BN / 16) * 16;  // r: the part's packed row
    cp_async16(smem + (r / kStage) * T::SLOT + (r % kStage) * BNP + c,
               a.w + static_cast<size_t>(j0 * kBlock + r) * n + mv_column<BN>(a, tile, c), 16);
  }
#pragma unroll 1
  for (int e = tid; e < jper * 4 * (BN / 4); e += THREADS) {
    const int row = e / (BN / 4), c = e % (BN / 4) * 4;  // row = 4 jl + 2 plane + (zs?)
    const float* base = (row & 1) ? a.zs : a.s;
    cp_async16(scl + row * BN + c,
               base + static_cast<size_t>(((row >> 1) & 1) * nbj + j0 + (row >> 2)) * n +
                   mv_column<BN>(a, tile, c), 16);
  }
  grid_wait();
  grid_launch();
  constexpr int ACH = MT * 128 + 2 * MPAD / 4;  // 16-byte pieces of a stage's x: fragments, sums
#pragma unroll 1
  for (int e = tid; e < nstage * ACH; e += THREADS) {
    const int st = e / ACH, q = e % ACH, c0 = j0 * SPB + st;  // c0: the stage's chunk of each plane
    uint32_t* adst = reinterpret_cast<uint32_t*>(smem + st * T::SLOT + T::W_BYTES);
    if (q < MT * 128) {
      const int mt = q / 128, off = q % 128 * 4;
      cp_async16(adst + mt * 512 + off, xfrag + static_cast<size_t>(mt * chunks + c0) * 512 + off, 16);
    } else {
      const int pl = (q - MT * 128) / (MPAD / 4), c = (q - MT * 128) % (MPAD / 4) * 4;
      cp_async16(reinterpret_cast<float*>(adst + T::A_WORDS) + pl * MPAD + c,
                 xsum + static_cast<size_t>(pl * chunks + c0) * MPAD + c, 16);
    }
  }
  cp_async_commit();
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  cp_async_wait<0>();
  __syncthreads();

  const int col0 = wn * 32 + 8 * t;  // C registers 0, 1: row g, slab columns 8t + i, 8t + 4 + i
  float* mine = xch + (ws * WN + wn) * T::PSUM + lane;  // this warp's partial sums
#pragma unroll 1
  for (int jl = 0; jl < jper; ++jl) {
    const unsigned char* slot = smem + (jl * SPB + ws) * T::SLOT;
    float p[2][MT][4][4];  // [plane][m16 tile][n8 tile][C register]
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[pl][mt][i][c] = 0.f;
    const uint8_t* wsrc = slot + wn * 32 + 4 * g;
    const uint32_t* fa = reinterpret_cast<const uint32_t*>(slot + T::W_BYTES) + lane * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // n8 tile i, column g is slab column 4 g + i: byte i of the 32-bit
      // words of rows (2t, 2t+1) and (2t+8, 2t+9) of this k16 step.
      const int rows[4] = {h * 16 + 2 * t, h * 16 + 2 * t + 1, h * 16 + 2 * t + 8, h * 16 + 2 * t + 9};
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = *reinterpret_cast<const uint32_t*>(wsrc + rows[r] * BNP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
        const uint32_t lo = packed::prmt(w[0], w[1], sel), hi = packed::prmt(w[2], w[3], sel);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          const uint32_t b0 = packed::raw_to_bf16x2(lo >> (4 * pl), 0x000F000Fu);
          const uint32_t b1 = packed::raw_to_bf16x2(hi >> (4 * pl), 0x000F000Fu);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint4 af = *reinterpret_cast<const uint4*>(fa + mt * 512 + (pl * 2 + h) * 128);
            packed::mma_bf16(p[pl][mt][i], af, b0, b1);
          }
        }
      }
    }
    // The block's sum: its stages' partial sums, added in stage order; warp
    // ws then applies the block affine to plane ws / 2 of column half ws % 2
    // (slab columns 8t + 4 (ws % 2) + i, i < 4: four neighbouring cells) and
    // sends the four terms of a row to their cells' part at once.
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) mine[(((pl * MT + mt) * 4 + i) * 4 + c) * 32] = p[pl][mt][i][c];
    __syncthreads();
    if (jl == 0) cluster_wait();  // the other parts have started
    {
      const int pl = ws >> 1, hc = ws & 1;
      const float* sums = reinterpret_cast<const float*>(smem + (jl * SPB) * T::SLOT + T::W_BYTES +
                                                         T::A_WORDS * 4) + pl * MPAD;
      const float* sp = scl + (jl * 4 + 2 * pl) * BN + col0 + 4 * hc;
      const float* zp = sp + BN;
      float* box = inbox + static_cast<size_t>(pl * nbj + j0 + jl) * share;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = mt * 16 + g + 8 * rh, r = 2 * rh + hc;
          if (row >= a.rows) continue;
          float x = sums[row];  // the block's four chunk sums, in k order
#pragma unroll
          for (int k = 1; k < SPB; ++k) x = __fadd_rn(x, sums[k * (T::SLOT / 4) + row]);
          float term[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* q = xch + wn * T::PSUM + lane + (((pl * MT + mt) * 4 + i) * 4 + r) * 32;
            float pv = q[0];
#pragma unroll
            for (int k = 1; k < SPB; ++k) pv = __fadd_rn(pv, q[k * WN * T::PSUM]);
            term[i] = __fsub_rn(__fmul_rn(pv, sp[i]), __fmul_rn(x, zp[i]));
          }
          const int cell = mv_cell<BN>(a, row, col0 + 4 * hc);
          *reinterpret_cast<float4*>(cluster.map_shared_rank(box + cell % share, cell / share)) =
              make_float4(term[0], term[1], term[2], term[3]);
        }
    }
    if (jl + 1 < jper) __syncthreads();  // the exchange is free for the next block
  }
  cluster.sync();  // every part's terms are in their inboxes

  // This part's cells: the terms of the K-blocks in block order.
  const int nb = 2 * nbj, cells = a.rows * BN, first = part * share;
  auto total = [&](int i) {
    float sum = inbox[i];
#pragma unroll 4
    for (int b = 1; b < nb; ++b) sum = __fadd_rn(sum, inbox[static_cast<size_t>(b) * share + i]);
    return sum;
  };
  if (a.pair == 0) {
#pragma unroll 1
    for (int i = tid; i < share && first + i < cells; i += THREADS) {
      const int cell = first + i, row = cell / BN, c = cell % BN;
      a.out[static_cast<size_t>(row) * a.ld + mv_column<BN>(a, tile, c)] = total(i);
    }
  } else {  // a warp per (row, 32 inputs of the down matvec)
    const Staged nx(a.next, MPAD, a.pair);
#pragma unroll 1
    for (int u = warp; u < share / 64 && first + 64 * u < cells; u += THREADS / 32) {
      const int i = 64 * u + lane / 4 * 8 + lane % 4, k = (first + 64 * u) / 2 + lane;  // k = row * BN/2 + c
      const float gv = total(i), uv = total(i + 4);
      stage_chunk(nx, k / (BN / 2), tile * (BN / 2) + (k % (BN / 2) & ~31), gv / (1.f + expf(-gv)) * uv);
    }
  }
}

// ── residual + RMSNorm ───────────────────────────────────────────────────

// Row blockIdx.x: xres = xin (when given), else xres + add; y = xres *
// rsqrt(mean(xres^2) + eps) * w, staged for the next matvec (mpad rows,
// depth d) and, with y_out, written in f32. Dynamic shared memory d floats;
// d a multiple of 32.
__global__ void __launch_bounds__(kLnThreads)
rms_stage(float* __restrict__ xres, const float* __restrict__ xin, const float* __restrict__ add,
          const float* __restrict__ w, float* __restrict__ y_out, float* staged, int mpad, int d,
          float eps) {
  extern __shared__ float xsm[];
  __shared__ float red[32];
  grid_wait();
  grid_launch();
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  float sq = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = xin != nullptr ? xin[off + i] : xres[off + i] + add[off + i];
    xres[off + i] = v;
    xsm[i] = v;
    sq += v * v;
  }
  const float r = rsqrtf(block_reduce<false>(sq, red) / d + eps);
  const Staged s(staged, mpad, d);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {  // whole warps: d is a multiple of 32
    const float y = xsm[i] * r * w[i];
    if (y_out != nullptr) y_out[off + i] = y;
    stage_chunk(s, blockIdx.x, i - (i & 31), y);
  }
}

// x (rows, k) f32 staged as a matvec input; grid (k / 256, rows), 256 threads.
__global__ void stage_rows(const float* __restrict__ x, int k, float* staged, int mpad) {
  grid_wait();
  grid_launch();
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  stage_chunk(Staged(staged, mpad, k), blockIdx.y, kk - (kk & 31),
              x[static_cast<size_t>(blockIdx.y) * k + kk]);
}

// ── attention ────────────────────────────────────────────────────────────

// The vectors of kv head h, from the slot's q|k|v matvec output row: for
// each of its G q heads, qf = RoPE(RMSNorm(q)) * 128^-0.5 and qs = bf16(qf);
// with `fresh`, kf = RoPE(RMSNorm(k)) and vf = v. Warp g < G rebuilds q head
// g, warp G the fresh k (and v), each in registers: lane l holds columns l +
// 32 i, so a column's RoPE partner (64 away) is in the same lane. The caller
// synchronises before reading them.
template <int G>
__device__ __forceinline__ void head_vectors(const float* qkv, int qd, int kvw, int h,
                                             const float* qn, const float* kn, const float* cosr,
                                             const float* sinr, float eps, bool fresh,
                                             float (*qs)[kQHd], float (*qf)[kQHd], float* kf,
                                             float* vf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp > G || (warp == G && !fresh)) return;
  const bool isq = warp < G;
  const float* src = qkv + (isq ? (h * G + warp) * kQHd : qd + h * kQHd);
  const float* nw = isq ? qn : kn;
  float v[4], ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = src[lane + 32 * i];
    ss += v[i] * v[i];
  }
  const float r = rsqrtf(warp_sum(ss) / kQHd + eps);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = v[i] * r * nw[lane + 32 * i];
  // RoPE (rotate_half: [-x[64:], x[:64]]): column d's partner is d + 64 or d - 64
  const float scale = isq ? 0.088388347648318440f : 1.f;  // 128 ** -0.5 for q
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    const float rot = i < 2 ? -v[i + 2] : v[i - 2];
    const float o = (v[i] * cosr[d] + rot * sinr[d]) * scale;
    if (isq) {
      qf[warp][d] = o;
      qs[warp][d] = bf16r(o);
    } else {
      kf[d] = o;
      vf[d] = qkv[qd + kvw + h * kQHd + d];
    }
  }
}

// 16 bytes of a cached row, raw.
template <typename T>
__device__ __forceinline__ uint4 load_raw16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Those 16 bytes as floats rounded to bf16 (exact for a bf16 row).
__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[4]) {
  const float f[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
                      __uint_as_float(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = bf16r(f[i]);
}

__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Max (kMax) or sum over the block of G values at once; every thread gets
// the results. `red` holds G x 32 floats.
template <bool kMax, int G>
__device__ __forceinline__ void block_reduce_g(float (&v)[G], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    v[g] = kMax ? warp_max(v[g]) : warp_sum(v[g]);
    if (lane == 0) red[g * 32 + warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float r = lane < nw ? red[g * 32 + lane] : (kMax ? -INFINITY : 0.f);
    v[g] = kMax ? warp_max(r) : warp_sum(r);
  }
  __syncthreads();
}

struct Attn {
  const float* qkv;              // (slots, qn): the q|k|v matvec's output
  const float *qn_s, *kn_s;      // the layer's q / k RMSNorm scales
  const float *cosr, *sinr;      // (slots, 128) RoPE rows
  void *kc, *vc;                 // the layer's caches; slot sl's plane at sl * t * kvw
  const int* pos;                // (slots,) device positions, or null: batch 1 at pos1
  int pos1, shift;               // batch 1: the rows [shift, pos1), the fresh row at pos1
  int qn, qd, kvw, t, min_rows, cap;  // cap: score rows a chunk may hold
  float eps;
  float* staged;                 // the o-projection's staged input (depth qd)
  int mpad;
};

constexpr int kAttnRowThreads = 256;  // = kGroups * kQHd: one thread per context value
constexpr int kAttnSmemBytes = 32768;  // k and v of a chunk's first rows, copied before the wait

// Dynamic shared memory of an attention block: the scores of `cap` rows for
// each q head, then the k and v of the chunk's first rows (64 of bf16, 32
// of f32).
__host__ __device__ inline size_t attn_smem(int cap) {
  return (static_cast<size_t>(kGroups) * cap * 4 + 15) / 16 * 16 + kAttnSmemBytes;
}

// grid (max_chunks, kv heads, slots), cluster (max_chunks, 1, 1): block c
// of the cluster of (kv head h, slot sl) is chunk c of that slot's rows.
// A cached row is read by 16 lanes (bf16) or 32 (f32), 16 bytes a lane, and
// lane group r of the block takes rows r, r + 16 (8), ... of the chunk; the
// k and v of its first 64 (bf16) or 32 (f32) rows are copied to shared
// memory (cp.async) before the wait for the q|k|v matvec: no kernel of the
// chain writes them. Pass 1 scores the
// chunk's rows for the G q heads and keeps each q head's max and sum of
// exponentials; chunk 0 also rebuilds the fresh k and v, writes them into
// the caches and scores the fresh row in f32. After a cluster barrier each
// chunk reads every chunk's statistics across the cluster, rounds its
// probabilities after the global normalisation and sums P.V over its rows;
// chunk 0 adds the fresh row's p * v in f32. After a second barrier chunk 0
// adds the chunks' contexts in chunk order and stages the result for the
// o-projection. Chunks past the slot's count only join the barriers.
template <typename T>
__global__ void __launch_bounds__(kAttnRowThreads) attn_step(const Attn a) {
  constexpr int G = kGroups;
  constexpr int EPL = 16 / sizeof(T);         // row elements a lane reads
  constexpr int LPR = kQHd / EPL;             // lanes a row
  constexpr int RPP = kAttnRowThreads / LPR;  // rows the block reads at once
  constexpr int SROWS = kAttnSmemBytes / (2 * kQHd * sizeof(T));  // rows staged in shared memory
  extern __shared__ __align__(16) float sc[];  // [G][cap] scores, then probabilities; then k, v rows
  __shared__ float qs[G][kQHd], qf[G][kQHd], kf[kQHd], vf[kQHd];
  __shared__ float red[G * 32];
  __shared__ float stat[G][2];                // this chunk's max and sum of exponentials
  __shared__ float norm[G][2];                // every chunk's: the global max and sum
  __shared__ float every[G][2][kMaxChunks];   // every chunk's statistics, read across the cluster
  __shared__ float pvp[RPP][G][kQHd];
  __shared__ float ctx[G][kQHd];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.x, h = blockIdx.y, sl = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, li = lane % LPR, grp = tid / LPR;
  int rows, base;
  bool write;
  if (a.pos == nullptr) {
    rows = a.pos1 - a.shift;
    base = a.shift;
    write = true;
  } else {  // written before the step
    const int p = a.pos[sl];
    write = p >= 0 && p < a.t;
    rows = write ? p : 0;
    base = 0;
  }
  const int nc = attn_chunks(rows, a.min_rows, gridDim.x);
  const bool live = c < nc;
  const size_t first = (static_cast<size_t>(sl) * a.t + base) * a.kvw + h * kQHd;
  T* kb = static_cast<T*>(a.kc) + first;  // row j of the attended range at kb + j * kvw
  T* vb = static_cast<T*>(a.vc) + first;
  int r0 = 0, r1 = 0;
  if (live) chunk_rows(rows, nc, c, &r0, &r1);
  T* krow = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sc) +
                                 (static_cast<size_t>(G) * a.cap * 4 + 15) / 16 * 16);  // [SROWS][128]
  T* vrow = krow + SROWS * kQHd;
  const int staged = min(r1 - r0, SROWS);
  for (int e = tid; e < 2 * staged * LPR; e += kAttnRowThreads) {
    const int kv = e / (staged * LPR), jj = e % (staged * LPR) / LPR, q = e % LPR;
    cp_async16((kv ? vrow : krow) + jj * kQHd + q * EPL,
               (kv ? vb : kb) + static_cast<size_t>(r0 + jj) * a.kvw + q * EPL, 16);
  }
  cp_async_commit();
  grid_wait();
  grid_launch();
  float snew[G];
  if (live) {
    head_vectors<G>(a.qkv + static_cast<size_t>(sl) * a.qn, a.qd, a.kvw, h, a.qn_s, a.kn_s,
                    a.cosr + sl * kQHd, a.sinr + sl * kQHd, a.eps, c == 0, qs, qf, kf, vf);
    cp_async_wait<0>();
    __syncthreads();
    if (c == 0) {
      if (write && tid < kQHd) {
        store(kb + static_cast<size_t>(rows) * a.kvw + tid, kf[tid]);
        store(vb + static_cast<size_t>(rows) * a.kvw + tid, vf[tid]);
      }
      const int warp = tid >> 5;
      if (warp < G) {  // the fresh row's score, f32
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < kQHd / 32; ++i) d = fmaf(qf[warp][lane + 32 * i], kf[lane + 32 * i], d);
        d = warp_sum(d);
        if (lane == 0) norm[warp][0] = d;
      }
      __syncthreads();
    }
#pragma unroll
    for (int g = 0; g < G; ++g) snew[g] = c == 0 ? norm[g][0] : 0.f;
    float q[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) q[g][e] = qs[g][li * EPL + e];
    float m[G];
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = c == 0 ? snew[g] : -INFINITY;
    // every lane of a warp runs the same passes: the lane groups of a warp
    // take neighbouring rows, and the shuffles need the whole warp
    const int passes = (r1 - r0 - (grp - grp % (32 / LPR)) + RPP - 1) / RPP;
    for (int i = 0; i < passes; ++i) {
      const int j = r0 + grp + i * RPP;
      const bool ok = j < r1;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (ok) {
        raw = j - r0 < SROWS ? *reinterpret_cast<const uint4*>(krow + (j - r0) * kQHd + li * EPL)
                                     : load_raw16(kb + static_cast<size_t>(j) * a.kvw + li * EPL);
      }
      float v[EPL], d[G];
      unpack16(raw, v);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        d[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d[g] = fmaf(q[g][e], v[e], d[g]);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d[g] += __shfl_xor_sync(0xffffffffu, d[g], o);
        if (ok) {
          m[g] = fmaxf(m[g], d[g]);
          if (li == 0) sc[g * a.cap + j - r0] = d[g];
        }
      }
    }
    block_reduce_g<true, G>(m, red);
    float l[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] = 0.f;
      for (int jj = tid; jj < r1 - r0; jj += kAttnRowThreads) l[g] += expf(sc[g * a.cap + jj] - m[g]);
      if (c == 0 && tid == 0) l[g] += expf(snew[g] - m[g]);
    }
    block_reduce_g<false, G>(l, red);
    if (tid < G) {
      stat[tid][0] = m[tid];
      stat[tid][1] = l[tid];
    }
  }
  if (!live) cp_async_wait<0>();
  cluster.sync();
  if (live) {
    if (tid < G * 2 * kMaxChunks) {  // every chunk's statistics, all read at once
      const int g = tid / (2 * kMaxChunks), k = tid / kMaxChunks % 2, i = tid % kMaxChunks;
      if (i < nc) every[g][k][i] = *cluster.map_shared_rank(&stat[g][k], i);
    }
    __syncthreads();
    if (tid < G) {  // combined in chunk order
      float big = -INFINITY, sum = 0.f;
      for (int i = 0; i < nc; ++i) big = fmaxf(big, every[tid][0][i]);
      for (int i = 0; i < nc; ++i)
        if (every[tid][1][i] > 0.f) sum += every[tid][1][i] * expf(every[tid][0][i] - big);
      norm[tid][0] = big;
      norm[tid][1] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int jj = tid; jj < r1 - r0; jj += kAttnRowThreads)
        sc[g * a.cap + jj] = bf16r(expf(sc[g * a.cap + jj] - norm[g][0]) / norm[g][1]);
    __syncthreads();
    float acc[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    for (int j = r0 + grp; j < r1; j += RPP) {
      const uint4 raw = j - r0 < SROWS
                            ? *reinterpret_cast<const uint4*>(vrow + (j - r0) * kQHd + li * EPL)
                            : load_raw16(vb + static_cast<size_t>(j) * a.kvw + li * EPL);
      float v[EPL];
      unpack16(raw, v);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = sc[g * a.cap + j - r0];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pr, v[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) pvp[grp][g][li * EPL + e] = acc[g][e];
    __syncthreads();
    const int g = tid / kQHd, dd = tid % kQHd;
    float s = 0.f;
#pragma unroll 4
    for (int i = 0; i < RPP; ++i) s += pvp[i][g][dd];
    if (c == 0) s += expf(snew[g] - norm[g][0]) / norm[g][1] * vf[dd];
    ctx[g][dd] = s;
  }
  cluster.sync();
  if (c == 0) {  // the chunks' contexts in chunk order, staged for the o-projection
    const int g = tid / kQHd, dd = tid % kQHd;
    float part[kMaxChunks];  // every chunk's context, all read at once, then added in chunk order
#pragma unroll
    for (int i = 1; i < kMaxChunks; ++i)
      if (i < nc) part[i] = *cluster.map_shared_rank(&ctx[g][dd], i);
    float s = ctx[g][dd];
#pragma unroll
    for (int i = 1; i < kMaxChunks; ++i)
      if (i < nc) s += part[i];
    stage_chunk(Staged(a.staged, a.mpad, a.qd), sl, (h * G + g) * kQHd + (dd & ~31), s);
  }
  cluster.sync();  // no chunk leaves while chunk 0 still reads its context
}

// ── the step ─────────────────────────────────────────────────────────────

// The plan the wrappers pass (ops/fused_decode.py: decode_plan), kPlanInts
// ints: (BN, parts) of the q|k|v, o, gate|up, down and head matvecs, the
// attention's min rows a chunk, max chunks (its cluster size) and the score
// rows a chunk holds, and whether launches are chained (programmatic
// dependent launch; off only to profile the kernels one at a time).
enum { kQkv, kO, kGu, kDown, kHead };
struct Plan {
  int bn[5], parts[5], min_rows, max_chunks, cap, pdl;
  explicit Plan(const int* p) : min_rows(p[10]), max_chunks(p[11]), cap(p[12]), pdl(p[13]) {
    for (int i = 0; i < 5; ++i) {
      bn[i] = p[2 * i];
      parts[i] = p[2 * i + 1];
    }
  }
};

template <int MT, int WARPS>
cudaError_t launch_matvec_t(const Mv& a, int pdl, cudaStream_t st) {
  using T = MvTile<MT, WARPS>;
  auto kernel = nibble_matvec<MT, WARPS>;
  static packed::SmemLimit limit;
  const cudaError_t attr = limit.ensure(kernel, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = mv_smem<MT, WARPS>(a.k, a.rows, a.parts);
  if (smem > static_cast<size_t>(kMaxSmem) || a.k / 2 / kBlock / a.parts > kMaxBlocksPerPart)
    return cudaErrorInvalidValue;
  return launch(kernel, dim3(a.parts, a.n / T::BN), dim3(T::THREADS), smem, st, pdl, a.parts, a);
}

// Checks the (BN, parts) of a matvec against its shape and launches it;
// cudaErrorInvalidValue for a plan this file has no kernel for.
inline cudaError_t launch_matvec(const Mv& a, int bn, int pdl, cudaStream_t st) {
  const int nbj = a.k / 2 / kBlock;
  if (a.k % (2 * kBlock) || a.rows < 1 || a.rows > 32 || a.parts < 1 || a.parts > kMaxParts ||
      nbj % a.parts || (bn != 32 && bn != 64) || a.n % bn ||
      (a.pair != 0 && (bn < 64 || a.n != 2 * a.pair)))
    return cudaErrorInvalidValue;
  const bool two = a.rows > 16;
  if (bn == 32) return two ? launch_matvec_t<2, 1>(a, pdl, st) : launch_matvec_t<1, 1>(a, pdl, st);
  return two ? launch_matvec_t<2, 2>(a, pdl, st) : launch_matvec_t<1, 2>(a, pdl, st);
}

// Checks the chunk rule and score rows of a plan against the caches' T rows
// (the longest chunk is ceil((T - 1) / chunks) rows, or fewer than min_rows)
// and launches the attention; cudaErrorInvalidValue for a plan it refuses.
template <typename T>
cudaError_t launch_attn(const Attn& a, int nkv, int slots, int max_chunks, int pdl, cudaStream_t st) {
  auto kernel = attn_step<T>;
  static packed::SmemLimit limit;
  const cudaError_t attr = limit.ensure(kernel, kMaxSmem / 2);
  if (attr != cudaSuccess) return attr;
  const size_t smem = attn_smem(a.cap);
  if (max_chunks < 1 || max_chunks > kMaxChunks || a.min_rows < 1 || smem > kMaxSmem / 2 ||
      a.cap < a.min_rows || static_cast<long long>(a.cap) * max_chunks < a.t - 1)
    return cudaErrorInvalidValue;
  return launch(kernel, dim3(max_chunks, nkv, slots), dim3(kAttnRowThreads), smem, st, pdl,
                max_chunks, a);
}

// Scratch, in floats, each part 16-byte aligned: xres, the q|k|v output and
// the o / down output (rows each), then the staged inputs of q|k|v, gate|up
// and the head (one buffer, depth H), of the o-projection (depth nh * 128)
// and of down (depth F), for mpad rows.
struct Scratch {
  size_t qkv, mv, sy, so, sd, floats;
  static size_t up4(size_t v) { return (v + 3) / 4 * 4; }
  Scratch(int rows, int h, int nh, int nkv, int f) {
    const int mpad = rows > 16 ? 32 : 16;
    const size_t qn = static_cast<size_t>(nh + 2 * nkv) * kQHd;
    qkv = up4(static_cast<size_t>(rows) * h);
    mv = qkv + up4(rows * qn);
    sy = mv + up4(static_cast<size_t>(rows) * h);
    so = sy + up4(Staged::floats(mpad, h));
    sd = so + up4(Staged::floats(mpad, nh * kQHd));
    floats = sd + up4(Staged::floats(mpad, f));
  }
};

// The whole step on `st`: rows slots (1 for the batch-1 kernel, with pos
// null and the host's pos1 / shift; else pos on the device, shift 0).
// Caches (NL, rows, T, nkv*128). Returns the first launch error.
template <typename T>
cudaError_t run_step(const Weights& W, const Plan& P, const float* x, const float* cosr,
                     const float* sinr, T* kc, T* vc, const int* pos, int pos1, int shift,
                     float* hidden, float* logits, float* scratch, int nl, int rows, int h, int nh,
                     int nkv, int f, int t, int vp, float eps, cudaStream_t st) {
  const Scratch S(rows, h, nh, nkv, f);
  const int mpad = rows > 16 ? 32 : 16;
  float *xres = scratch, *qkv = scratch + S.qkv, *mv = scratch + S.mv;
  float *sy = scratch + S.sy, *so = scratch + S.so, *sd = scratch + S.sd;
  const int qd = nh * kQHd, kvw = nkv * kQHd, qn = qd + 2 * kvw;
  const size_t kbh = h / 2 / kBlock, kbo = qd / 2 / kBlock, kbf = f / 2 / kBlock;
  const int pdl = P.pdl;
  const size_t rsm = sizeof(float) * h;
  Attn at{qkv, nullptr, nullptr, cosr, sinr, nullptr, nullptr, pos, pos1, shift, qn, qd, kvw, t,
          P.min_rows, P.cap, eps, so, mpad};
  auto mv_args = [&](const float* xin, const int8_t* w, const float* s, const float* zs, int k,
                     int n, int which, float* out, int ld) {
    return Mv{xin, w, s, zs, k, n, rows, P.parts[which], 0, out, ld, nullptr};
  };
  cudaError_t err = launch(rms_stage, dim3(rows), dim3(kLnThreads), rsm, st, pdl, 0, xres, x,
                           static_cast<const float*>(nullptr), W.in_s, static_cast<float*>(nullptr),
                           sy, mpad, h, eps);
  for (int l = 0; l < nl && err == cudaSuccess; ++l) {
    const bool last = l + 1 == nl;
    const size_t L = l;
    Mv m = mv_args(sy, W.wq + L * (h / 2) * qn, W.qkv_s + L * 2 * kbh * qn,
                   W.qkv_zs + L * 2 * kbh * qn, h, qn, kQkv, qkv, qn);
    err = launch_matvec(m, P.bn[kQkv], pdl, st);
    if (err != cudaSuccess) break;
    at.qn_s = W.qn_s + L * kQHd;
    at.kn_s = W.kn_s + L * kQHd;
    at.kc = kc + L * rows * t * kvw;
    at.vc = vc + L * rows * t * kvw;
    err = launch_attn<T>(at, nkv, rows, P.max_chunks, pdl, st);
    if (err != cudaSuccess) break;
    m = mv_args(so, W.wo + L * (qd / 2) * h, W.o_s + L * 2 * kbo * h, W.o_zs + L * 2 * kbo * h, qd,
                h, kO, mv, h);
    err = launch_matvec(m, P.bn[kO], pdl, st);
    if (err != cudaSuccess) break;
    err = launch(rms_stage, dim3(rows), dim3(kLnThreads), rsm, st, pdl, 0, xres,
                 static_cast<const float*>(nullptr), static_cast<const float*>(mv), W.post_s + L * h,
                 static_cast<float*>(nullptr), sy, mpad, h, eps);
    if (err != cudaSuccess) break;
    m = mv_args(sy, W.wgu + L * (h / 2) * 2 * f, W.gu_s + L * 2 * kbh * 2 * f,
                W.gu_zs + L * 2 * kbh * 2 * f, h, 2 * f, kGu, nullptr, 0);
    m.pair = f;
    m.next = sd;
    err = launch_matvec(m, P.bn[kGu], pdl, st);
    if (err != cudaSuccess) break;
    m = mv_args(sd, W.wd + L * (f / 2) * h, W.dn_s + L * 2 * kbf * h, W.dn_zs + L * 2 * kbf * h, f, h,
                kDown, mv, h);
    err = launch_matvec(m, P.bn[kDown], pdl, st);
    if (err != cudaSuccess) break;
    err = launch(rms_stage, dim3(rows), dim3(kLnThreads), rsm, st, pdl, 0, xres,
                 static_cast<const float*>(nullptr), static_cast<const float*>(mv),
                 last ? W.fn_s : W.in_s + (L + 1) * h, last ? hidden : static_cast<float*>(nullptr),
                 sy, mpad, h, eps);
  }
  if (err == cudaSuccess && W.wh != nullptr) {
    const Mv m = mv_args(sy, W.wh, W.h_s, W.h_zs, h, vp, kHead, logits, vp);
    err = launch_matvec(m, P.bn[kHead], pdl, st);
  }
  return err;
}

}  // namespace
}  // namespace qwen
