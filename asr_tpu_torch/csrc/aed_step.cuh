// The AED decode step shared by fused_aed_step.cu (batch 1) and
// fused_aed_multi.cu (B slots) for Hopper (sm_90a): one design, one code
// path for every slot's arithmetic, so a slot of the multi-slot step
// computes, bitwise, what the batch-1 step computes for it alone.
//
// The step is the pre-LN encoder-decoder block of asr_tpu/ops/
// fused_aed_step.py:_kernel and fused_aed_multi.py:_kernel: per layer
//   LN1 -> self q|k|v -> self-attention over cache[:pos] and the fresh row
//   (written into the caches at pos in place) -> o-proj + residual -> LN ->
//   cross-q -> cross-attention over rows < tc_valid -> cross-o + residual ->
//   LN2 -> fc1 -> exact GELU -> fc2 + residual,
// then the final LayerNorm and the q8 tied head. It is a chain of 11
// kernels a layer (+ the first LayerNorm, + the head), each launched with
// programmatic dependent launch (cudaLaunchAttributeProgrammaticStream-
// Serialization): a kernel starts while its predecessor drains, and every
// block runs griddepcontrol.wait before it reads or writes anything a
// kernel of the step produces, then griddepcontrol.launch_dependents. Only
// weight, scale and cache-row copies, which no kernel of the step writes,
// go out before the wait.
//
//   q8_matvec  q|k|v, self-o, cross-q, cross-o, fc1, fc2 and the head: the
//              int8 product on tensor cores (below)
//   attn_aed   one launch an attention: a thread block cluster per (head,
//              slot) holds its row chunks
//   ln_stage   LayerNorm of one slot row
//
// Staged inputs. Every matvec input is written once a step by the kernel
// that produces it (ln_stage: the LayerNorm output; attn_aed: the sum of
// the chunk contexts; fc1: GELU(h)), rounded to bf16, in mma A-fragment
// order, with the sum of each 32-value chunk of rounded values. Matvec
// blocks only copy it (16-byte cp.async).
//
// The matvec. out[row, n] for int8 columns of a weight (row stride ldw) with
// block-128 scales s and zero*scale zs (K/128 rows of the same stride).
// Slots are the rows of an m16 tile (two tiles above 16 slots), the raw
// int8 values the B operand of mma.sync m16n8k16 (bf16 in, f32 accumulate):
// each weight byte is read once a step for all slots. Per 128-row block b:
//   p_b  = its 8 k16 steps accumulated in order by one warp's mma   (f32)
//   xs_b = the block's four chunk sums, added in k order             (f32)
//   t_b  = p_b * s_b - xs_b * zs_b                                   (f32)
// A tile of BN columns (a warp a 32-column slab) splits K into `parts`
// equal runs of whole 128-row blocks (the plan). Part r folds its blocks'
// terms in block order, P_r = t_{j0} + t_{j0+1} + ...; the parts of a tile
// form one thread block cluster, each sends P_r to the inbox of the part
// that owns the output (distributed shared memory), and the owner adds
// P_0 + P_1 + ... in part order, then the bias, the residual (o-proj,
// cross-o, fc2: (x + sum) + bias) or the exact GELU (fc1, staged once as
// fc2's input). No partial sum goes through device memory. The split, the
// tile and every order depend on (K, N) alone, and mma.sync's result for a
// row does not depend on the other rows of the tile or on its place in it,
// so a slot's bits never depend on the slot count.
//
// Rounding points (the TPU kernels'): matvec inputs bf16, int8 weights
// exact, the block affine above in f32; cached-row scores bf16(q * 64^-0.5)
// . bf16(k), the fresh row's score and p * v in f32 from the unrounded q,
// k, v; probabilities rounded to bf16 after the global max and sum;
// LayerNorm, softmax, GELU (erff) and residuals in f32.
//
// Rows of a staged input past the live slot count (the rest of an m16 tile)
// are never written: mma rows are independent, and no live output reads
// them.
#pragma once

#include <utility>

#include "aed_common.cuh"
#include "packed_common.cuh"

// Internal linkage: the batch-1 and multi-slot libraries each keep their
// own copy (a function-local static of a template with external linkage
// would be shared between the two once both are loaded).
namespace aedstep {
namespace {

using namespace aed;
namespace cg = cooperative_groups;
using packed::cp_async16;
using packed::cp_async_commit;
using packed::cp_async_wait;
using packed::mma_bf16;
using packed::prmt;

constexpr int kChunk = 32;                        // values a staged chunk sum covers: two k16 steps
constexpr int kChunksPerBlock = kBlock / kChunk;  // 4
constexpr int kMaxParts = 8;        // parts of a matvec tile: one cluster of portable size
constexpr int kMaxChunks = 8;       // row chunks of an attention: one cluster of portable size
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may take on an H100
constexpr int kAttnSmem = kMaxSmem / 2;  // an attention block's (its static arrays take the rest)
constexpr int kWPad = 16;           // padding bytes after each staged weight row
constexpr int kRowThreads = 256;    // an attention chunk
constexpr int kPlanInts = 21;       // the plan the wrappers pass, see Plan
constexpr float kScale = 0.125f;    // 64 ** -0.5

// Two signed bytes (the low byte of each 16-bit half of v) -> two bf16,
// exactly: 128 + (q & 0x7F) by its mantissa bits, plus -(128 + (q & 0x80))
// (quant_matmul_int8.cu builds its B fragments the same way).
__device__ __forceinline__ uint32_t s8_to_bf16x2(uint32_t v) {
  uint32_t lo7, neg;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(lo7) : "r"(v), "r"(0x007F007Fu), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(neg) : "r"(v), "r"(0x00800080u), "r"(0xC300C300u));
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo7), "r"(0x3F803F80u), "r"(neg));
  return r;
}

// The stacked weights of a step: LayerNorm scales and biases (NL, D), the
// final LayerNorm (D), biases ba (NL, 6D + F) and bb (NL, D), the
// column-concatenated wa_all (NL, D, 6D + F) = q|k|v|o|cq|co|fc1 with its
// block scales (NL, D/128, 6D + F), fc2 wb (NL, F, D) with (NL, F/128, D),
// and the tied head wh (D, V_pad) with (D/128, V_pad).
struct Weights {
  const float *ln1_s, *ln1_b, *lnc_s, *lnc_b, *ln2_s, *ln2_b, *lnf_s, *lnf_b, *ba, *bb;
  const int8_t *wa, *wb, *wh;
  const float *a_s, *a_zs, *b_s, *b_zs, *h_s, *h_zs;
};

inline Weights make_weights(const void* ln1_s, const void* ln1_b, const void* lnc_s, const void* lnc_b,
                            const void* ln2_s, const void* ln2_b, const void* lnf_s, const void* lnf_b,
                            const void* ba, const void* bb, const void* wa, const void* a_s,
                            const void* a_zs, const void* wb, const void* b_s, const void* b_zs,
                            const void* wh, const void* h_s, const void* h_zs) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  return Weights{f(ln1_s), f(ln1_b), f(lnc_s), f(lnc_b), f(ln2_s), f(ln2_b), f(lnf_s), f(lnf_b),
                 f(ba),    f(bb),    i8(wa),   i8(wb),   i8(wh),   f(a_s),   f(a_zs),  f(b_s),
                 f(b_zs),  f(h_s),   f(h_zs)};
}

// ── staged matvec inputs ─────────────────────────────────────────────────

// The staged input of a matvec of depth k for mpad rows (16 or 32): frag,
// mpad * k/2 words of bf16 pairs in the order [m16 tile][chunk c < k/32]
// [k16 half][lane][4 registers] (the mma A fragment of rows 16 mt.., k = 32 c
// + 16 half + ..), then sums[c * mpad + row], the sum of chunk c's 32
// rounded values.
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
  const int c = k0 / kChunk, half = lane >> 4, q = lane & 15;
  const int reg = ((row >> 3) & 1) + 2 * (q >> 3);
  const size_t word = (static_cast<size_t>((row >> 4) * (s.k / kChunk) + c) * 2 + half) * 128 +
                      (4 * (row & 7) + ((q & 7) >> 1)) * 4 + reg;
  reinterpret_cast<__nv_bfloat16*>(s.frag)[2 * word + (q & 1)] = __float2bfloat16_rn(r);
  const float sum = warp_sum(r);
  if (lane == 0) s.sums[static_cast<size_t>(c) * s.mpad + row] = sum;
}

// ── the matvec ───────────────────────────────────────────────────────────

enum MvMode { kOut = 0, kResid = 1, kGelu = 2 };

struct Mv {
  const float* x;       // staged input (Staged layout: mpad rows, depth k)
  const int8_t* w;      // (k, n) int8 columns of a weight of row stride ldw
  const float* s;       // (k/128, n) scales, row stride ldw
  const float* zs;      // (k/128, n) zero * scale, row stride ldw
  const float* bias;    // (n,), or null
  int k, n, ldw, rows, parts, mode;
  float* out;           // kOut: out[row * ld + c] = sum + bias; kResid: (out + sum) + bias
  int ld;
  float* next;          // kGelu: GELU(sum + bias) staged as the next matvec's input (depth n)
};

template <int MT, int WN>
struct MvTile {
  static constexpr int MPAD = 16 * MT;
  static constexpr int BN = 32 * WN;  // a warp a 32-column slab: 4 n8 tiles
  static constexpr int THREADS = 32 * WN;
  static constexpr int BNP = BN + kWPad;  // staged weight row pitch (bytes)
  static constexpr int W_BYTES = kBlock * BNP;  // a 128-row block's weights
  static constexpr int X_WORDS = kChunksPerBlock * MT * 256;  // its x fragments
  static constexpr int BLK = W_BYTES + X_WORDS * 4 + kChunksPerBlock * MPAD * 4;  // + the chunk sums
};

// Output cells a part of a tile owns: the tile's rows * BN cells split into
// `parts` shares, each a multiple of 64 (whole 32-cell runs of one row).
__host__ __device__ inline int mv_share(int rows, int bn, int parts) {
  const int per = (rows * bn + parts - 1) / parts;
  return (per + 63) / 64 * 64;
}

// Shared memory of a matvec block: its 128-row blocks (weight rows, x
// fragments, chunk sums), their scales (s and zs), then its inbox, the
// partial sums of every part for the cells it owns.
template <int MT, int WN>
size_t mv_smem(int k, int rows, int parts) {
  using T = MvTile<MT, WN>;
  const size_t jper = k / kBlock / parts;
  return jper * T::BLK + jper * 2 * T::BN * 4 + static_cast<size_t>(parts) * mv_share(rows, T::BN, parts) * 4;
}

// grid (parts, n / BN), cluster (parts, 1, 1). Part r of a tile takes the
// 128-row blocks [r jper, (r + 1) jper), jper = K/128 / parts, all in flight
// at once: the weights and scales before the wait for the kernel before,
// the x fragments after. Warp wn sums its slab over each block's 8 k16
// steps, applies the block affine and folds the terms in block order in
// registers; then it sends the part's sums to their cells' owners
// (distributed shared memory: stores, no waiting), and after one cluster
// barrier every part adds its cells' sums in part order.
template <int MT, int WN>
__global__ void __launch_bounds__(32 * WN) q8_matvec(const Mv a) {
  using T = MvTile<MT, WN>;
  constexpr int BN = T::BN, THREADS = T::THREADS, BNP = T::BNP, MPAD = T::MPAD;
  constexpr int CPB = kChunksPerBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, wn = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int part = blockIdx.x, tile = blockIdx.y;
  const int jper = a.k / kBlock / a.parts, j0 = part * jper, chunks = a.k / kChunk;
  const int share = mv_share(a.rows, BN, a.parts);
  const int col0 = tile * BN;
  const uint32_t* xfrag = reinterpret_cast<const uint32_t*>(a.x);
  const float* xsum = a.x + static_cast<size_t>(MPAD) * a.k / 2;
  float* scl = reinterpret_cast<float*>(smem + static_cast<size_t>(jper) * T::BLK);  // [jl][s, zs][BN]
  float* inbox = scl + jper * 2 * BN;  // [part][share]

  // The weights and scales do not depend on the kernel before: they go out
  // before the wait for it.
#pragma unroll 1
  for (int e = tid; e < jper * kBlock * (BN / 16); e += THREADS) {
    const int r = e / (BN / 16), c = e % (BN / 16) * 16;  // r: the part's row
    cp_async16(smem + (r / kBlock) * T::BLK + (r % kBlock) * BNP + c,
               a.w + static_cast<size_t>(j0 * kBlock + r) * a.ldw + col0 + c, 16);
  }
#pragma unroll 1
  for (int e = tid; e < jper * 2 * (BN / 4); e += THREADS) {
    const int row = e / (BN / 4), c = e % (BN / 4) * 4;  // row = 2 jl + (zs?)
    const float* base = (row & 1) ? a.zs : a.s;
    cp_async16(scl + row * BN + c, base + static_cast<size_t>(j0 + (row >> 1)) * a.ldw + col0 + c, 16);
  }
  grid_wait();
  grid_launch();
  constexpr int FP = CPB * MT * 64;  // 16-byte pieces of a block's x fragments
  constexpr int XP = FP + MPAD;      // and of its chunk sums (4 x MPAD floats)
#pragma unroll 1
  for (int e = tid; e < jper * XP; e += THREADS) {
    const int jl = e / XP, q = e % XP, cb = (j0 + jl) * CPB;  // cb: the block's first chunk
    unsigned char* dst = smem + static_cast<size_t>(jl) * T::BLK + T::W_BYTES;
    if (q < FP) {
      const int ch = q / (MT * 64), mt = q / 64 % MT, off = q % 64 * 4;
      cp_async16(reinterpret_cast<uint32_t*>(dst) + (ch * MT + mt) * 256 + off,
                 xfrag + (static_cast<size_t>(mt) * chunks + cb + ch) * 256 + off, 16);
    } else {
      const int off = (q - FP) * 4;
      cp_async16(reinterpret_cast<float*>(dst + T::X_WORDS * 4) + off,
                 xsum + static_cast<size_t>(cb) * MPAD + off, 16);
    }
  }
  cp_async_commit();
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  cp_async_wait<0>();
  __syncthreads();

  // C registers of n8 tile i: 0 (row g) and 2 (row g + 8) at slab column
  // 8t + i, 1 and 3 at 8t + 4 + i: byte i of the word of columns 4g..4g+3
  // is column g of n8 tile i.
  float run[MT][4][4];
#pragma unroll 1
  for (int jl = 0; jl < jper; ++jl) {
    const unsigned char* blk = smem + static_cast<size_t>(jl) * T::BLK;
    const unsigned char* wsrc = blk + wn * 32 + 4 * g;
    const uint32_t* fa = reinterpret_cast<const uint32_t*>(blk + T::W_BYTES) + lane * 4;
    float p[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[mt][i][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2 * CPB; ++ks) {  // the block's k16 steps, in order
      const unsigned char* rsrc = wsrc + (ks * 16 + 2 * t) * BNP;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rsrc);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rsrc + BNP);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(rsrc + 8 * BNP);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(rsrc + 9 * BNP);
      uint4 af[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        af[mt] = *reinterpret_cast<const uint4*>(fa + ((ks >> 1) * MT + mt) * 256 + (ks & 1) * 128);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
        const uint32_t b0 = s8_to_bf16x2(prmt(w0, w1, sel)), b1 = s8_to_bf16x2(prmt(w2, w3, sel));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(p[mt][i], af[mt], b0, b1);
      }
    }
    // t_b = p * s - xs * zs, folded in block order
    const float* sums = reinterpret_cast<const float*>(blk + T::W_BYTES + T::X_WORDS * 4);
    const float* sp = scl + jl * 2 * BN + wn * 32 + 8 * t;
    const float* zp = sp + BN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = mt * 16 + g + 8 * rh;
        float x = sums[row];  // the block's four chunk sums, in k order
#pragma unroll
        for (int c = 1; c < CPB; ++c) x = __fadd_rn(x, sums[c * MPAD + row]);
#pragma unroll
        for (int hc = 0; hc < 2; ++hc)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 2 * rh + hc, col = 4 * hc + i;
            const float term = __fsub_rn(__fmul_rn(p[mt][i][r], sp[col]), __fmul_rn(x, zp[col]));
            run[mt][i][r] = jl == 0 ? term : __fadd_rn(run[mt][i][r], term);
          }
      }
  }
  // The part's sums, four neighbouring cells at once, to the owners' inboxes.
  cluster_wait();  // the other parts have started
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = mt * 16 + g + 8 * rh;
      if (row >= a.rows) continue;
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int r = 2 * rh + hc, cell = row * BN + wn * 32 + 8 * t + 4 * hc;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(inbox + part * share + cell % share, cell / share)) =
            make_float4(run[mt][0][r], run[mt][1][r], run[mt][2][r], run[mt][3][r]);
      }
    }
  cluster.sync();  // every part's sums are in their inboxes

  // This part's cells: the parts' sums in part order.
  const int cells = a.rows * BN, first = part * share;
  auto total = [&](int i) {
    float sum = inbox[i];
    for (int r = 1; r < a.parts; ++r) sum = __fadd_rn(sum, inbox[r * share + i]);
    return sum;
  };
  if (a.mode != kGelu) {
#pragma unroll 1
    for (int i = tid; i < share && first + i < cells; i += THREADS) {
      const int cell = first + i, col = col0 + cell % BN;
      float* o = a.out + static_cast<size_t>(cell / BN) * a.ld + col;
      float v = total(i);
      if (a.mode == kResid) v = __fadd_rn(*o, v);
      if (a.bias != nullptr) v = __fadd_rn(v, a.bias[col]);
      *o = v;
    }
  } else {  // a warp per 32 neighbouring cells of one row: fc2's inputs
    const Staged nx(a.next, MPAD, a.n);
#pragma unroll 1
    for (int u = wn; u < share / 32 && first + 32 * u < cells; u += THREADS / 32) {
      const int cell = first + 32 * u + lane, col = col0 + cell % BN;
      const float v = __fadd_rn(total(32 * u + lane), a.bias[col]);
      stage_chunk(nx, cell / BN, col - lane, 0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
    }
  }
}

// ── LayerNorm ────────────────────────────────────────────────────────────

// Row blockIdx.x: xres = xin (when given), else xres as it is; y =
// LayerNorm(xres) * ls + lb, staged for the next matvec (mpad rows, depth
// d). d / 4 threads (at most 1024; d a multiple of 128): each loads its 16
// bytes of the row at once. Dynamic shared memory d floats.
__global__ void __launch_bounds__(1024)
ln_stage(float* __restrict__ xres, const float* __restrict__ xin, const float* __restrict__ ls,
         const float* __restrict__ lb, float* staged, int mpad, int d, float eps) {
  extern __shared__ float4 xsm4[];
  __shared__ float red[32];
  grid_wait();
  grid_launch();
  const float* xsm = reinterpret_cast<const float*>(xsm4);
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  float sum = 0.f;
  for (int i = threadIdx.x; i < d / 4; i += blockDim.x) {
    float4 v;
    if (xin != nullptr) {
      v = reinterpret_cast<const float4*>(xin + off)[i];
      reinterpret_cast<float4*>(xres + off)[i] = v;
    } else {
      v = reinterpret_cast<const float4*>(xres + off)[i];
    }
    xsm4[i] = v;
    sum += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = block_reduce<false>(sum, red) / d;
  float sq = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = xsm[i] - mean;
    sq += c * c;
  }
  const float rstd = rsqrtf(block_reduce<false>(sq, red) / d + eps);
  const Staged s(staged, mpad, d);
  for (int i = threadIdx.x; i < d; i += blockDim.x)  // whole warps: d is a multiple of 32
    stage_chunk(s, blockIdx.x, i - (i & 31), (xsm[i] - mean) * rstd * ls[i] + lb[i]);
}

// x (rows, k) f32 staged as a matvec input; grid (k / 128, rows), 128 threads.
__global__ void stage_rows(const float* __restrict__ x, int k, float* staged, int mpad) {
  grid_wait();
  grid_launch();
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  stage_chunk(Staged(staged, mpad, k), blockIdx.y, kk - (kk & 31),
              x[static_cast<size_t>(blockIdx.y) * k + kk]);
}

// ── attention ────────────────────────────────────────────────────────────

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

struct Attn {
  const float* q;       // (slots, ldq) matvec output: q of head h at h*64; self: k at d + h*64, v at 2d + h*64
  int ldq;
  void *kc, *vc;        // the layer's caches; slot sl's plane at sl * t * d
  const int* rows_dev;  // (slots,) self: pos (-1 parks), cross: tc_valid; or null: batch 1
  int rows1;            // batch 1: pos, or tc_valid
  int t, d, min_rows, cap, srows;  // cap: score rows a chunk holds; srows: k (then v) rows it stages
  float* staged;        // the o-projection's staged input (depth d)
  int mpad;
};

// Dynamic shared memory of an attention block: the scores of `cap` rows,
// then the chunk's first `srows` rows of k, later of v.
__host__ __device__ inline size_t attn_smem(int cap, int srows, int itemsize) {
  return (static_cast<size_t>(cap) * 4 + 15) / 16 * 16 + static_cast<size_t>(srows) * kHd * itemsize;
}

// grid (max_chunks, heads, slots), cluster (max_chunks, 1, 1): block c of the
// cluster of (head h, slot sl) is chunk c of that slot's rows (self: the
// cached rows [0, pos); cross: [0, tc_valid)). Before the wait for the
// matvec, the chunk's k rows (up to srows) go to shared memory as 16-byte
// cp.async copies: no kernel of the chain writes them; its v rows follow
// into the same buffer as soon as the scores are taken, while the
// statistics go round the cluster. One buffer keeps a block small, so
// several blocks share an SM and one's copies overlap another's math. A
// cached row is read by 16 lanes (f32) or 8 (bf16), 16 bytes a lane. Pass 1
// scores the chunk's rows and keeps their max and sum of exponentials;
// chunk 0 of the self attention also writes the fresh k and v into the
// caches at pos (not for a parked slot) and scores the fresh row in f32.
// After a cluster barrier each chunk holds every chunk's statistics,
// rounds its probabilities after the global
// normalisation and sums P.V over its rows; chunk 0 adds the fresh row's
// p * v in f32. After a second barrier chunk 0 adds the chunks' contexts in
// chunk order and stages the result for the o-projection. Statistics and
// contexts go to the chunks that need them as stores into their shared
// memory (distributed shared memory), so no block waits on a remote read.
// Chunks past the slot's count only join the barriers.
template <typename T, bool kSelf>
__global__ void __launch_bounds__(kRowThreads) attn_aed(const Attn a) {
  constexpr int EPL = 16 / sizeof(T);     // row elements a lane reads
  constexpr int LPR = kHd / EPL;          // lanes a row
  constexpr int RPP = kRowThreads / LPR;  // rows the block reads at once
  extern __shared__ __align__(16) float sc[];  // [cap] scores, then probabilities; then k rows, later v rows
  __shared__ float qs[kHd], qf[kHd], kf[kHd], vf[kHd];
  __shared__ float red[32];
  __shared__ float norm[3];               // the global max and sum; the fresh row's score
  __shared__ float every[2][kMaxChunks];  // every chunk's max and sum of exponentials, sent by it
  __shared__ float pvp[RPP][kHd];
  __shared__ float ctxs[kMaxChunks][kHd];  // chunk 0: every chunk's context, sent by it
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.x, h = blockIdx.y, sl = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, li = lane % LPR, grp = tid / LPR;
  const int want = a.rows_dev != nullptr ? a.rows_dev[sl] : a.rows1;  // written before the step
  const bool write = kSelf && want >= 0 && want < a.t;
  const int rows = kSelf ? (write ? want : 0) : min(max(want, 1), a.t);
  const int nc = attn_chunks(rows, a.min_rows, gridDim.x);
  const bool live = c < nc;
  const bool fresh = kSelf && c == 0;
  const size_t first = static_cast<size_t>(sl) * a.t * a.d + h * kHd;
  T* kb = static_cast<T*>(a.kc) + first;  // row j of the slot's cache at kb + j * d
  T* vb = static_cast<T*>(a.vc) + first;
  int r0 = 0, r1 = 0;
  if (live) chunk_rows(rows, nc, c, &r0, &r1);
  T* krow = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sc) + (static_cast<size_t>(a.cap) * 4 + 15) / 16 * 16);
  T* vrow = krow;  // the same buffer, once the scores are taken
  const int staged = min(r1 - r0, a.srows);
  auto stage_rows_of = [&](T* dst, const T* src) {
    for (int e = tid; e < staged * LPR; e += kRowThreads) {
      const int jj = e / LPR, q = e % LPR;
      cp_async16(dst + jj * kHd + q * EPL, src + static_cast<size_t>(r0 + jj) * a.d + q * EPL, 16);
    }
    cp_async_commit();
  };
  stage_rows_of(krow, kb);
  grid_wait();
  grid_launch();
  cluster_arrive();
  float snew = 0.f, m = -INFINITY, l = 0.f;
  if (live) {
    if (tid < kHd) {
      const float* qrow = a.q + static_cast<size_t>(sl) * a.ldq + h * kHd;
      const float q = qrow[tid];
      qf[tid] = q;
      qs[tid] = bf16r(q * kScale);
      if (fresh) {
        kf[tid] = qrow[a.d + tid];
        vf[tid] = qrow[2 * a.d + tid];
      }
    }
    __syncthreads();
    if (fresh) {
      if (write && tid < kHd) {
        store(kb + static_cast<size_t>(rows) * a.d + tid, kf[tid]);
        store(vb + static_cast<size_t>(rows) * a.d + tid, vf[tid]);
      }
      if (tid < 32) {  // the fresh row's score, f32
        float d = qf[lane] * kf[lane] * kScale + qf[lane + 32] * kf[lane + 32] * kScale;
        d = warp_sum(d);
        if (lane == 0) norm[2] = d;
      }
      __syncthreads();
      snew = norm[2];
    }
    float q[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) q[e] = qs[li * EPL + e];
    cp_async_wait<0>();  // the k rows
    __syncthreads();
    m = fresh ? snew : -INFINITY;
    // every lane of a warp runs the same passes: the lane groups of a warp
    // take neighbouring rows, and the shuffles need the whole warp
    const int passes = (r1 - r0 - (grp - grp % (32 / LPR)) + RPP - 1) / RPP;
    for (int i = 0; i < passes; ++i) {
      const int j = r0 + grp + i * RPP;
      const bool ok = j < r1;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (ok) {
        raw = j - r0 < a.srows ? *reinterpret_cast<const uint4*>(krow + (j - r0) * kHd + li * EPL)
                               : load_raw16(kb + static_cast<size_t>(j) * a.d + li * EPL);
      }
      float v[EPL];
      unpack16(raw, v);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(q[e], v[e], d);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (ok) {
        m = fmaxf(m, d);
        if (li == 0) sc[j - r0] = d;
      }
    }
    m = block_reduce<true>(m, red);  // ends with a barrier: every k row is read
    stage_rows_of(vrow, vb);
    for (int jj = tid; jj < r1 - r0; jj += kRowThreads) l += expf(sc[jj] - m);
    if (fresh && tid == 0) l += expf(snew - m);
    l = block_reduce<false>(l, red);
  }
  cluster_wait();  // every block of the cluster has started
  if (live && tid < 2 * nc) {  // this chunk's statistics to every chunk
    const int k = tid / nc, dst = tid % nc;
    *cluster.map_shared_rank(&every[k][c], dst) = k ? l : m;
  }
  cluster.sync();
  if (live) {
    if (tid == 0) {  // combined in chunk order
      float big = -INFINITY, sum = 0.f;
      for (int i = 0; i < nc; ++i) big = fmaxf(big, every[0][i]);
      for (int i = 0; i < nc; ++i)
        if (every[1][i] > 0.f) sum += every[1][i] * expf(every[0][i] - big);
      norm[0] = big;
      norm[1] = sum;
    }
    __syncthreads();
    for (int jj = tid; jj < r1 - r0; jj += kRowThreads) sc[jj] = bf16r(expf(sc[jj] - norm[0]) / norm[1]);
    cp_async_wait<0>();
    __syncthreads();
    float acc[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
    for (int j = r0 + grp; j < r1; j += RPP) {
      const uint4 raw = j - r0 < a.srows ? *reinterpret_cast<const uint4*>(vrow + (j - r0) * kHd + li * EPL)
                                         : load_raw16(vb + static_cast<size_t>(j) * a.d + li * EPL);
      float v[EPL];
      unpack16(raw, v);
      const float pr = sc[j - r0];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pr, v[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) pvp[grp][li * EPL + e] = acc[e];
    __syncthreads();
    if (tid < kHd) {
      float s = 0.f;
#pragma unroll 4
      for (int i = 0; i < RPP; ++i) s += pvp[i][tid];
      if (fresh) s += expf(snew - norm[0]) / norm[1] * vf[tid];
      *cluster.map_shared_rank(&ctxs[c][tid], 0) = s;  // to chunk 0
    }
  } else {
    cp_async_wait<0>();
  }
  cluster.sync();  // chunk 0 holds every context; no block reads another's memory after it
  if (c == 0 && tid < kHd) {  // the chunks' contexts in chunk order, staged for the o-projection
    float s = ctxs[0][tid];
    for (int i = 1; i < nc; ++i) s += ctxs[i][tid];
    stage_chunk(Staged(a.staged, a.mpad, a.d), sl, h * kHd + (tid & ~31), s);
  }
}

// ── the step ─────────────────────────────────────────────────────────────

// The plan the wrappers pass (ops/fused_aed_step.py: aed_plan), kPlanInts
// ints: (BN, parts) of the q|k|v, self-o, cross-q, cross-o, fc1, fc2 and head
// matvecs; the attentions' min rows a chunk and max chunks (their cluster
// size); the self attention's score rows a chunk holds and k / v rows it
// stages, then the cross attention's; whether launches are chained
// (programmatic dependent launch; off only to profile the kernels one at a
// time).
enum { kQkv, kSo, kCq, kCo, kFc1, kFc2, kHead, kMatvecs };
struct Plan {
  int bn[kMatvecs], parts[kMatvecs], min_rows, max_chunks, self_cap, self_srows, cross_cap, cross_srows,
      pdl;
  explicit Plan(const int* p)
      : min_rows(p[14]), max_chunks(p[15]), self_cap(p[16]), self_srows(p[17]), cross_cap(p[18]),
        cross_srows(p[19]), pdl(p[20]) {
    for (int i = 0; i < kMatvecs; ++i) {
      bn[i] = p[2 * i];
      parts[i] = p[2 * i + 1];
    }
  }
};

template <int MT, int WN>
cudaError_t launch_matvec_t(const Mv& a, int pdl, cudaStream_t st) {
  using T = MvTile<MT, WN>;
  auto kernel = q8_matvec<MT, WN>;
  static packed::SmemLimit limit;
  const cudaError_t attr = limit.ensure(kernel, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = mv_smem<MT, WN>(a.k, a.rows, a.parts);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  return launch(kernel, dim3(a.parts, a.n / T::BN), dim3(T::THREADS), smem, st, pdl, a.parts, a);
}

// Shared memory of the matvec of column tile bn split into `parts` over
// depth k, for `rows` slots; 0 for a tile this file has no kernel for.
inline size_t matvec_smem(int bn, int parts, int k, int rows) {
  const bool two = rows > 16;
  switch (bn) {
    case 32: return two ? mv_smem<2, 1>(k, rows, parts) : mv_smem<1, 1>(k, rows, parts);
    case 64: return two ? mv_smem<2, 2>(k, rows, parts) : mv_smem<1, 2>(k, rows, parts);
    case 128: return two ? mv_smem<2, 4>(k, rows, parts) : mv_smem<1, 4>(k, rows, parts);
    default: return 0;
  }
}

// Checks the (BN, parts) of a matvec against its shape and launches it;
// cudaErrorInvalidValue for a plan this file has no kernel for.
inline cudaError_t launch_matvec(const Mv& a, int bn, int pdl, cudaStream_t st) {
  const int nb = a.k / kBlock;
  if (a.k % kBlock || a.rows < 1 || a.rows > 32 || a.parts < 1 || a.parts > kMaxParts || nb % a.parts ||
      (bn != 32 && bn != 64 && bn != 128) || a.n % bn || (a.mode == kGelu && a.bias == nullptr))
    return cudaErrorInvalidValue;
  const bool two = a.rows > 16;
  if (bn == 32) return two ? launch_matvec_t<2, 1>(a, pdl, st) : launch_matvec_t<1, 1>(a, pdl, st);
  if (bn == 64) return two ? launch_matvec_t<2, 2>(a, pdl, st) : launch_matvec_t<1, 2>(a, pdl, st);
  return two ? launch_matvec_t<2, 4>(a, pdl, st) : launch_matvec_t<1, 4>(a, pdl, st);
}

// Checks the chunk rule, score rows and staged rows of a plan against the
// caches' t rows (the longest chunk is ceil(t_rows / chunks) rows, or
// fewer than min_rows) and launches the attention; cudaErrorInvalidValue
// for a plan it refuses.
template <typename T, bool kSelf>
cudaError_t launch_attn(const Attn& a, int t_rows, int heads, int slots, int max_chunks, int pdl,
                        cudaStream_t st) {
  auto kernel = attn_aed<T, kSelf>;
  static packed::SmemLimit limit;
  const cudaError_t attr = limit.ensure(kernel, kAttnSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = attn_smem(a.cap, a.srows, sizeof(T));
  if (max_chunks < 1 || max_chunks > kMaxChunks || a.min_rows < 1 || smem > kAttnSmem ||
      a.cap < a.min_rows || a.srows < 0 || a.srows > a.cap ||
      static_cast<long long>(a.cap) * max_chunks < t_rows)
    return cudaErrorInvalidValue;
  return launch(kernel, dim3(max_chunks, heads, slots), dim3(kRowThreads), smem, st, pdl, max_chunks, a);
}

// Scratch, in floats, each part 16-byte aligned: xres (rows x D), the q|k|v
// output (rows x 3D) and the cross-q output (rows x D), then the staged
// inputs of the LayerNorm outputs and of the attention contexts (depth D)
// and of fc2 (depth F), for mpad rows.
struct Scratch {
  size_t qkv, cq, sy, so, sh, floats;
  static size_t up4(size_t v) { return (v + 3) / 4 * 4; }
  Scratch(int rows, int d, int f) {
    const int mpad = rows > 16 ? 32 : 16;
    qkv = up4(static_cast<size_t>(rows) * d);
    cq = qkv + up4(static_cast<size_t>(rows) * 3 * d);
    sy = cq + up4(static_cast<size_t>(rows) * d);
    so = sy + up4(Staged::floats(mpad, d));
    sh = so + up4(Staged::floats(mpad, d));
    floats = sh + up4(Staged::floats(mpad, f));
  }
};

// The whole step on `st`: rows slots (1 for the batch-1 kernel, with pos and
// tcv null and the host's pos1 / tc1; else pos and tcv on the device).
// Self caches (NL, rows, t_self, D), cross caches (NL, rows, t_cross, D).
// Returns the first launch error.
template <typename T>
cudaError_t run_step(const Weights& W, const Plan& P, const float* x, T* kself, T* vself, T* ck, T* cv,
                     const int* pos, const int* tcv, int pos1, int tc1, float* logits, float* scratch,
                     int nl, int rows, int d, int heads, int f, int t_self, int t_cross, int vp,
                     float eps, cudaStream_t st) {
  const Scratch S(rows, d, f);
  const int mpad = rows > 16 ? 32 : 16;
  float *xres = scratch, *qkv = scratch + S.qkv, *cq = scratch + S.cq;
  float *sy = scratch + S.sy, *so = scratch + S.so, *sh = scratch + S.sh;
  const int na = 6 * d + f, pdl = P.pdl;
  const size_t kbd = d / kBlock, kbf = f / kBlock;
  const size_t lsm = sizeof(float) * d;
  const Attn self{qkv, 3 * d, nullptr, nullptr, pos, pos1, t_self, d, P.min_rows, P.self_cap,
                  P.self_srows, so, mpad};
  const Attn cross{cq, d, nullptr, nullptr, tcv, tc1, t_cross, d, P.min_rows, P.cross_cap,
                   P.cross_srows, so, mpad};
  auto mv = [&](int which, const float* xin, const int8_t* w, const float* s, const float* zs,
                const float* bias, int k, int n, int ldw, int mode, float* out, int ld, float* next) {
    return launch_matvec(Mv{xin, w, s, zs, bias, k, n, ldw, rows, P.parts[which], mode, out, ld, next},
                         P.bn[which], pdl, st);
  };
  const int ln_threads = std::min(d / 4, 1024);
  auto ln = [&](const float* xin, const float* ls, const float* lb) {
    return launch(ln_stage, dim3(rows), dim3(ln_threads), lsm, st, pdl, 0, xres, xin, ls, lb, sy, mpad, d,
                  eps);
  };
  cudaError_t err = ln(x, W.ln1_s, W.ln1_b);
  for (int l = 0; l < nl && err == cudaSuccess; ++l) {
    const size_t L = l;
    const int8_t* wa = W.wa + L * d * na;
    const float *as = W.a_s + L * kbd * na, *az = W.a_zs + L * kbd * na, *ba = W.ba + L * na;
    // self attention over each slot's cache rows [0, pos) and its fresh row
    if ((err = mv(kQkv, sy, wa, as, az, ba, d, 3 * d, na, kOut, qkv, 3 * d, nullptr))) break;
    Attn at = self;
    at.kc = kself + L * rows * t_self * d;
    at.vc = vself + L * rows * t_self * d;
    if ((err = launch_attn<T, true>(at, t_self - 1, heads, rows, P.max_chunks, pdl, st))) break;
    if ((err = mv(kSo, so, wa + 3 * d, as + 3 * d, az + 3 * d, ba + 3 * d, d, d, na, kResid, xres, d,
                  nullptr)))
      break;
    if ((err = ln(nullptr, W.lnc_s + L * d, W.lnc_b + L * d))) break;
    // cross attention over each slot's rows [0, tc_valid)
    if ((err = mv(kCq, sy, wa + 4 * d, as + 4 * d, az + 4 * d, ba + 4 * d, d, d, na, kOut, cq, d, nullptr)))
      break;
    at = cross;
    at.kc = ck + L * rows * t_cross * d;
    at.vc = cv + L * rows * t_cross * d;
    if ((err = launch_attn<T, false>(at, t_cross, heads, rows, P.max_chunks, pdl, st))) break;
    if ((err = mv(kCo, so, wa + 5 * d, as + 5 * d, az + 5 * d, ba + 5 * d, d, d, na, kResid, xres, d,
                  nullptr)))
      break;
    if ((err = ln(nullptr, W.ln2_s + L * d, W.ln2_b + L * d))) break;
    // MLP: fc1 stages GELU(h) as fc2's input
    if ((err = mv(kFc1, sy, wa + 6 * d, as + 6 * d, az + 6 * d, ba + 6 * d, d, f, na, kGelu, nullptr, 0,
                  sh)))
      break;
    if ((err = mv(kFc2, sh, W.wb + L * f * d, W.b_s + L * kbf * d, W.b_zs + L * kbf * d, W.bb + L * d, f,
                  d, d, kResid, xres, d, nullptr)))
      break;
    const bool last = l + 1 == nl;
    err = ln(nullptr, last ? W.lnf_s : W.ln1_s + (L + 1) * d, last ? W.lnf_b : W.ln1_b + (L + 1) * d);
  }
  // the tied head
  if (err == cudaSuccess) err = mv(kHead, sy, W.wh, W.h_s, W.h_zs, nullptr, d, vp, vp, kOut, logits, vp, nullptr);
  return err;
}

}  // namespace
}  // namespace aedstep
