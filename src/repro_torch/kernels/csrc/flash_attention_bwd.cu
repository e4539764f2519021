// Atomizable flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// causal / non-causal / windowed GQA attention from the forward's output O
// and its per-row log-sum-exp.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of the
// jnp `blocked_attention` (src/repro/models/attention.py:141).  The port's
// forward is the hand-written kernel of csrc/flash_attention.cu, which
// autograd cannot see through, so its gradient is this kernel.
//
// What bounds it on this card: operations.  The gradient needs five products
// of 2*D flops an unmasked (query, key) pair (S = Q K^T and dP = dO V^T
// recomputed, then dV += P^T dO, dK += dS^T Q, dQ += dS K): 10*D flops a
// pair, the bound.  This design issues seven (S and dP in both roles, below):
// 14*D flops a pair, its own floor.
//
// What the design does about it:
//   * a `delta` pass: delta[b,h,s] = sum_d dO*O in f32, one warp a row;
//   * one atom kernel over a flat tile space of two parts: dQ tiles t in
//     [0, B*Hq*ceil(Sq/BQ)), then dK/dV tiles u = t - that in
//     [0, B*Hk*ceil(Sk/BK)).  Within each part the tiles are numbered block
//     by block, heaviest causal block first: dQ tile t is head bh = t % (B*Hq)
//     and query block n_qblocks - 1 - t / (B*Hq); dK/dV tile u is KV head
//     bhk = u % (B*Hk) and key block u / (B*Hk) (`tile_of`; the wrapper's
//     `ref.bwd_tile` is the same map).  grid = (num_tiles,) with the block
//     index offset by `start`, so CTAs start in that order.  Every output
//     tile is owned by one CTA, so there are no atomics, and atoms over
//     disjoint ranges compose bit for bit in any order;
//   * both roles run in one block shape of 384 threads: warpgroup 0 is the
//     producer (one warp of it works; setmaxnreg gives its registers to the
//     consumers: 24 for it, 240 for them), warpgroups 1 and 2 are consumers,
//     each owning 64 rows of the tile's 128.  A tile keeps a resident pair of
//     128 rows in shared memory and streams the other pair through a ring of
//     STAGES blocks of 64 rows (full / empty mbarriers), so the next blocks
//     load under this one's products.  dQ tile: Q and dO resident, K and V
//     streamed over the keys its rows see; dK/dV tile: K and V resident, Q
//     and dO streamed over the G query heads of its KV head in order and
//     their query blocks that see its keys, with each block's lse and delta
//     staged beside it by the producer warp.  Every tile is TMA-loaded (4-D
//     maps {D, H, S, B} over the model's layout, 128-byte swizzle, boxes of
//     64 head-dim values by 128 or 64 rows); rows past Sq or Sk are
//     zero-filled;
//   * every product is a wgmma with f32 accumulation:
//       dK/dV: S^T = K Q^T, dP^T = V dO^T (both operands in shared memory);
//              dV += P^T dO, dK += dS^T Q (P^T, dS^T from the accumulators
//              rounded to bf16 as register A fragments; dO, Q MN-major);
//       dQ:    S = Q K^T, dP = dO V^T; dQ += dS K (K MN-major).
//     S^T and dP^T are two commit groups: the exponentials of P run while
//     dP^T is still in the tensor cores.  dK and dV (or dQ) stay in the
//     consumers' registers over the whole loop: at D = 128, 128 floats a
//     thread, plus 32 each for S^T and dP^T (~233 registers, no spill; the
//     waits' trap is a call, see hopper.cuh);
//   * P = exp2(S*scale*log2 e - lse*log2 e) from the natural-base lse
//     (ex2.approx); an empty row's lse is +inf, so its P is 0, never NaN;
//     dS = P (dP - delta); dQ and dK are scaled by `scale` at the store.
//     Masks are the forward's (true Sk, end-aligned causal, window), applied
//     only where a warp's 16 rows and the block meet an edge; rows past Sq
//     carry lse = +inf.  Blocks no row of the tile sees are never loaded.
// What holds it back: S and dP are computed twice (7 products a pair against
// 5), the price of owning every output tile in one CTA without atomics; one
// CTA an SM, so a tile's prologue (the resident pair's load) and epilogue
// (the stores) are not overlapped with another tile's products; the two
// consumer warpgroups run in step, so their exponentials leave the tensor
// cores idle together (letting them take turns with named barriers measured
// slower); the outputs are stored from registers as bf16 pairs.
//
// Two more paths take what this design cannot hold, over the same two-part
// tile space, masks, lse guard and ownership (one CTA an output tile, no
// atomics), with their own tile sizes (`flash_attention_bwd_block_q/_k(dtype,
// D)`):
//   * bfloat16 at head_dim 256 (`bwd_d256_kernel`).  Bound: operations, as
//     above (0.52 ms at recurrentgemma-9b's training shape: B=2, S=4096, 16
//     query heads on one KV head, window 2048).  A thread of the design above
//     would hold dK and dV for 64 keys x 256 columns (256 registers, over the
//     limit) and the resident pair of 128 rows alone is 128 KB.  The same
//     shape (producer warp, TMA ring with full / empty mbarriers, setmaxnreg,
//     masks only at edges, ex2.approx) with tiles cut to fit: a dQ tile is
//     128 query rows, 64 a consumer warpgroup (dQ 128 registers a thread),
//     with Q and dO resident (128 KB) and K, V streamed in blocks of 32 keys
//     through a ring of 3 (32 KB a stage); a dK/dV tile is 64 keys split by
//     role, K and V resident (64 KB), Q and dO streamed in blocks of 64 rows
//     through a ring of 2 (64 KB a stage): warpgroup A owns dV and computes
//     S^T and P^T, warpgroup B owns dK and computes dP^T; P^T crosses to B
//     as bf16 through two buffers of 8 KB, handed over by named barriers
//     between the two warpgroups (the producer never waits on them), so the
//     pair still issues seven products;
//   * float32 at head_dim 64, 128 and 256 (`bwd_tf32_kernel`): split TF32 on
//     the tensor cores.  Each operand x is hi = tf32(x) and lo = x - hi
//     truncated to TF32, and each product is lo_a hi_b + hi_a lo_b + hi_a hi_b
//     in f32: about 21 bits of each product where one TF32 product keeps 11
//     (the f32 limits, 1e-5 of a gradient's largest value, need the split;
//     ref.tf32_split_product is its plain emulation).  Bound: 10 D flops a
//     pair at the CUDA cores' 67 TFLOP/s (1.28 ms at olmo-1b's shape, B=2,
//     S=2048, H=16, D=128); the design's floor is 3 x 14 D flops a pair at
//     495 TFLOP/s TF32 (0.73 ms).  mma.sync m16n8k8, not wgmma: wgmma takes
//     tf32 operands K-major only and 64 rows a warpgroup, so three of the
//     five products would need transposed copies of their B operands, and
//     with hi and lo planes an element takes 8 bytes of shared memory (4x
//     bf16), which leaves no room for 64-row tiles and their transposes at
//     head_dim 128 and 256.  mma.sync reads each fragment with 32-bit shared
//     loads in either orientation, conflict-free at a row pitch of D + 4
//     floats, so every tile is stored once.  Streamed blocks land by
//     cp.async into a ring of two stages (the next block loads under this
//     one's products) and each thread splits the chunks it copied, in
//     place, once per load; the resident tile is split in registers as its
//     fragments load (below, `F32`), P and dS as they are made.  Tiles of
//     128 rows (32 at head_dim 256), 8 warps of 16 rows (4 at 256), streamed
//     blocks of 32 rows at head_dim 64 and 16 above.  The tensor cores add
//     into an accumulator rounding toward zero, so every chain of additions
//     is short and the running sums are added on the CUDA cores (`scores`).
//     P is exp(S*scale - lse) with expf; the outputs are f32.  What holds it
//     back: latency.  A thread holds 255 registers (dK and dV: 128), so an
//     SM runs 8 warps, and a block of 16 queries takes ~3x the issue slots
//     its instructions need; shared-memory traffic is ~40 % of the card's.
//     16 warps with the dK/dV roles split between them spilled at the
//     128-register cap (3.76 ms against 2.96), ldmatrix for the K-major
//     fragments changed nothing (2.95 against 2.94); in the hi/lo-plane
//     design 4 warps were slower than 8 (4.29 against 3.94).
// Other dtypes and head dims return -1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NTHREADS = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int BQ = 128;         // query rows of a dQ tile
constexpr int BK = 128;         // keys of a dK/dV tile
constexpr int BR = 128;         // rows of a tile's resident pair
constexpr int BS = 64;          // rows of a streamed block
constexpr int STAGES = 4;       // blocks in the ring
static_assert(BQ == BR && BK == BR, "one resident shape for both roles");

struct Maps {   // resident boxes of BR rows, streamed boxes of BS rows
  CUtensorMap q_res, do_res, k_res, v_res, q_str, do_str, k_str, v_str;
};

struct Args {
  const float *lse, *delta;     // [B, Hq, Sq], contiguous
  void *dq, *dk, *dv;           // bf16 or f32, as the inputs
  int start, n_dq_tiles, n_qblocks, BH, BHk, Hq, G, Sq, Sk;
  int causal, window;
  long long dq_b, dq_s, dq_h, dk_b, dk_s, dk_h, dv_b, dv_s, dv_h;
  float scale, scale_log2e;
};

template <int D>
struct Smem {
  static constexpr int NB = D / 64;             // 64-wide boxes of a row
  static constexpr int RBOX = BR * 128;         // one box of a resident tile
  static constexpr int SBOX = BS * 128;         // one box of a streamed block
  static constexpr int RES = NB * RBOX;         // one resident tile
  static constexpr int STR = NB * SBOX;         // one streamed block
  // resident pair, the two rings, lse / delta a stage, barriers, and room to
  // align the tiles to 1024 bytes
  static constexpr int BYTES = 1024 + 2 * RES + 2 * STAGES * STR +
                               2 * STAGES * BS * 4 + (1 + 2 * STAGES) * 8;
};
static_assert(Smem<128>::BYTES <= 232448, "227 KB of shared memory a block");

// the tile of flat index t: a dQ tile (b, q head, first query row) or a
// dK/dV tile (b, KV head, first key); heaviest causal blocks first.  TQ, TK:
// the query rows of a dQ tile and the keys of a dK/dV tile.
struct Tile {
  bool dq;
  int b, h, r0;
};

template <int TQ, int TK>
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  if (t < a.n_dq_tiles) {
    const int bh = t % a.BH, qi = a.n_qblocks - 1 - t / a.BH;
    return {true, bh / a.Hq, bh % a.Hq, qi * TQ};
  }
  const int u = t - a.n_dq_tiles, Hk = a.Hq / a.G;
  const int bhk = u % a.BHk;
  return {false, bhk / Hk, bhk % Hk, (u / a.BHk) * TK};
}

// the streamed blocks of SB rows a tile takes: [blk0, blk0 + n) of keys (dQ
// tile), or n = G * nq blocks, query blocks [blk0, blk0 + nq) of each head
// of the group in order (dK/dV tile)
struct Range {
  int blk0, nq, n;
};

template <int TQ, int TK, int SB>
__device__ __forceinline__ Range range_of(const Args& a, const Tile& tl) {
  const int off = a.Sk - a.Sq;   // qpos = off + query row
  int lo, hi;
  if (tl.dq) {
    const int q_last = min(tl.r0 + TQ, a.Sq) - 1;
    hi = a.causal ? min(a.Sk, off + q_last + 1) : a.Sk;
    lo = a.window > 0 ? max(0, off + tl.r0 - a.window + 1) : 0;
  } else {   // the query rows that see any key of this tile
    const int kv_last = min(tl.r0 + TK, a.Sk) - 1;
    lo = a.causal ? max(0, tl.r0 - off) : 0;
    hi = a.window > 0 ? min(a.Sq, kv_last + a.window - off) : a.Sq;
  }
  Range r;
  r.blk0 = lo / SB;
  r.nq = hi > lo ? (hi + SB - 1) / SB - r.blk0 : 0;
  r.n = tl.dq ? r.nq : a.G * r.nq;
  return r;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Sk, int causal,
                                        int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// keeps the compiler from moving accumulator registers across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// 2^x by the multi-function unit's approximation (ex2.approx: a few ulp)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

// acc[64 x D] += A (64 x 16, registers) * B (16 x D, shared, MN-major)
template <int D>
__device__ __forceinline__ void rs_step(float (&acc)[D / 2],
                                        const unsigned (&a)[4], uint64_t db) {
  if constexpr (D == 128)
    wgmma_m64n128k16_rs<1>(acc, a, db, 1);
  else
    wgmma_m64n64k16_rs<1>(acc, a, db, 1);
}

// s[64 x BS] = R (64 resident rows, descriptor dr) * S^T (a streamed block,
// descriptor ds), both K-major over the head dim.  A descriptor's low bits
// are its address / 16, so a k-step's is the tile's plus its offset / 16.
template <int D>
__device__ __forceinline__ void ss_product(float (&s)[BS / 2], uint64_t dr,
                                           uint64_t ds) {
  using M = Smem<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_m64n64k16_ss<0>(s, dr + ((ks / 4) * M::RBOX + (ks % 4) * 32) / 16,
                          ds + ((ks / 4) * M::SBOX + (ks % 4) * 32) / 16,
                          ks > 0);
}

// acc += frag (64 x BS, registers) * the streamed block at `str` (BS x D,
// MN-major)
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const unsigned (&frag)[BS / 16][4],
                                           uint32_t str) {
  const uint64_t d = wgmma_desc(str, Smem<D>::SBOX, 1024);
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk)
    rs_step<D>(acc, frag[kk], d + kk * 2048 / 16);
}

// an accumulator of 64 x BS as BS/16 A fragments of bf16
__device__ __forceinline__ void to_frags(unsigned (&f)[BS / 16][4],
                                         const float (&s)[BS / 2]) {
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk) {
    f[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    f[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    f[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    f[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// store a warpgroup's 64 rows of a [64 x D] accumulator, times `mul`, as
// bf16 pairs; rows at or past `limit` are not stored
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           int row0, int limit,
                                           const float (&acc)[D / 2],
                                           float mul) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row < limit) {
      bf16* p = base + (long long)row * row_stride + 2 * (lane & 3);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<unsigned*>(p + dt * 8) =
            pack_bf16(acc[4 * dt + 2 * r] * mul, acc[4 * dt + 2 * r + 1] * mul);
    }
  }
}

// The tile's shared memory, as 32-bit shared addresses: the resident pair
// r0, r1 ([box][BR][64] each), the streamed rings s0, s1 ([stage][box][BS]
// [64]), lse * log2 e and delta a stage ([stage][BS] f32), the barriers.
struct Shared {
  uint32_t r0, r1, s0, s1, lse, delta, res, full, empty;
};

// dQ of a warpgroup's 64 query rows (r0 + 64 wg ...) of head (b, h):
// resident Q, dO; streamed K, V
template <int D>
__device__ __forceinline__ void dq_consumer(const Args& a, const Tile& tl,
                                            const Range& rg, int wg,
                                            const Shared& sm) {
  using M = Smem<D>;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int off = a.Sk - a.Sq;
  const int qw = tl.r0 + wg * 64 + warp * 16;   // the warp's first row
  const long long bh = (long long)tl.b * a.Hq + tl.h;
  float lse2[2], dlt[2];   // rows g and g + 8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const bool in = row < a.Sq;
    lse2[r] = in ? a.lse[bh * a.Sq + row] * LOG2E : INFINITY;
    dlt[r] = in ? a.delta[bh * a.Sq + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (rg.n > 0) mbar_wait(sm.res, 0);
  const uint64_t dq_ = wgmma_desc(sm.r0 + wg * 64 * 128, 16, 1024);
  const uint64_t do_ = wgmma_desc(sm.r1 + wg * 64 * 128, 16, 1024);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < rg.n; ++i) {
    const int k0 = (rg.blk0 + i) * BS;
    mbar_wait(sm.full + 8 * stage, phase);
    const uint32_t kt = sm.s0 + stage * M::STR, vt = sm.s1 + stage * M::STR;
    float s[BS / 2], dp[BS / 2];
    wgmma_fence();
    ss_product<D>(s, dq_, wgmma_desc(kt, 16, 1024));
    wgmma_commit();
    ss_product<D>(dp, do_, wgmma_desc(vt, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // P from the saved lse, masked where the warp's rows meet an edge
    const bool edge = (k0 + BS > a.Sk) || (a.causal && k0 + BS - 1 > off + qw) ||
                      (a.window > 0 && k0 <= off + qw + 15 - a.window);
#pragma unroll
    for (int nt = 0; nt < BS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2_approx(s[4 * nt + e] * a.scale_log2e - lse2[r]);
        if (edge && !visible(k0 + nt * 8 + 2 * tq + (e & 1),
                             off + qw + g + 8 * r, a.Sk, a.causal, a.window))
          p = 0.f;
        s[4 * nt + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta), then dQ += dS K
#pragma unroll
    for (int nt = 0; nt < BS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * nt + e] *= dp[4 * nt + e] - dlt[e >> 1];
    unsigned f[BS / 16][4];
    to_frags(f, s);
    wgmma_fence();
    rs_product<D>(acc, f, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(sm.empty + 8 * stage);   // this warp is done
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<D>(static_cast<bf16*>(a.dq) + tl.b * a.dq_b + tl.h * a.dq_h,
                a.dq_s, tl.r0 + wg * 64, a.Sq, acc, a.scale);
}

// dK and dV of a warpgroup's 64 keys (r0 + 64 wg ...) of KV head (b, hk):
// resident K, V; streamed Q, dO with their rows' lse and delta
template <int D>
__device__ __forceinline__ void dkv_consumer(const Args& a, const Tile& tl,
                                             const Range& rg, int wg,
                                             const Shared& sm) {
  using M = Smem<D>;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int off = a.Sk - a.Sq;
  const int kw = tl.r0 + wg * 64 + warp * 16;   // the warp's first key
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (rg.n > 0) mbar_wait(sm.res, 0);
  const uint64_t dk_ = wgmma_desc(sm.r0 + wg * 64 * 128, 16, 1024);
  const uint64_t dv_ = wgmma_desc(sm.r1 + wg * 64 * 128, 16, 1024);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < rg.n; ++i) {
    const int q0 = (rg.blk0 + i % rg.nq) * BS;   // this block's first row
    mbar_wait(sm.full + 8 * stage, phase);
    const uint32_t qt = sm.s0 + stage * M::STR, ot = sm.s1 + stage * M::STR;
    const uint32_t lse2 = sm.lse + stage * BS * 4 + tq * 8;
    const uint32_t dlt = sm.delta + stage * BS * 4 + tq * 8;
    float st[BS / 2], dpt[BS / 2];   // S^T, dP^T: 64 keys x BS queries
    wgmma_fence();
    ss_product<D>(st, dk_, wgmma_desc(qt, 16, 1024));
    wgmma_commit();
    ss_product<D>(dpt, dv_, wgmma_desc(ot, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    const bool edge = (kw + 15 >= a.Sk) || (a.causal && kw + 15 > off + q0) ||
                      (a.window > 0 && kw <= off + q0 + BS - 1 - a.window);
#pragma unroll
    for (int nt = 0; nt < BS / 8; ++nt) {
      const float2 l2 = ld_shared_f32x2(lse2 + nt * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(st[4 * nt + e] * a.scale_log2e - ((e & 1) ? l2.y : l2.x));
        if (edge && !visible(kw + g + 8 * (e >> 1),
                             off + q0 + nt * 8 + 2 * tq + (e & 1), a.Sk,
                             a.causal, a.window))
          p = 0.f;
        st[4 * nt + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int nt = 0; nt < BS / 8; ++nt) {
      const float2 d2 = ld_shared_f32x2(dlt + nt * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * nt + e] = st[4 * nt + e] * (dpt[4 * nt + e] - ((e & 1) ? d2.y : d2.x));
    }
    // dV += P^T dO, dK += dS^T Q over this block's BS query rows
    unsigned pf[BS / 16][4], sf[BS / 16][4];
    to_frags(pf, st);
    to_frags(sf, dpt);
    wgmma_fence();
    rs_product<D>(dv, pf, ot);
    rs_product<D>(dk, sf, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(sm.empty + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<D>(static_cast<bf16*>(a.dk) + tl.b * a.dk_b + tl.h * a.dk_h,
                a.dk_s, tl.r0 + wg * 64, a.Sk, dk, a.scale);
  store_rows<D>(static_cast<bf16*>(a.dv) + tl.b * a.dv_b + tl.h * a.dv_h,
                a.dv_s, tl.r0 + wg * 64, a.Sk, dv, 1.f);
}

// the producer warp: the resident pair once (NB boxes of RBOX bytes each),
// then every streamed block of the tile through a ring of STG stages (SR
// rows, NB boxes of SBOX bytes an operand; for a dK/dV tile with its rows'
// lse * log2 e and delta, +inf and 0 past Sq, staged by the warp's 32
// lanes).  R and S are the maps of the resident and the streamed operands.
template <int NB, int STG, int SR, int RBOX, int SBOX>
__device__ __forceinline__ void produce(const CUtensorMap* R0,
                                        const CUtensorMap* R1,
                                        const CUtensorMap* S0,
                                        const CUtensorMap* S1, const Args& a,
                                        const Tile& tl, const Range& rg,
                                        const Shared& sm) {
  constexpr int STR = NB * SBOX;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect_tx(sm.res, 2 * NB * RBOX);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load_4d(sm.r0 + j * RBOX, R0, sm.res, 64 * j, tl.h, tl.r0, tl.b);
      tma_load_4d(sm.r1 + j * RBOX, R1, sm.res, 64 * j, tl.h, tl.r0, tl.b);
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < rg.n; ++i) {
    int head, row;
    if (tl.dq) {
      head = tl.h / a.G;
      row = (rg.blk0 + i) * SR;
    } else {
      head = tl.h * a.G + i / rg.nq;
      row = (rg.blk0 + i % rg.nq) * SR;
    }
    mbar_wait(sm.empty + 8 * stage, phase ^ 1);
    if (!tl.dq) {
      const long long base = ((long long)tl.b * a.Hq + head) * a.Sq;
#pragma unroll
      for (int c = lane; c < SR; c += 32) {
        const int rr = row + c;
        const bool in = rr < a.Sq;
        st_shared_f32(sm.lse + (stage * SR + c) * 4,
                      in ? a.lse[base + rr] * LOG2E : INFINITY);
        st_shared_f32(sm.delta + (stage * SR + c) * 4,
                      in ? a.delta[base + rr] : 0.f);
      }
      __syncwarp();
    }
    if (lane == 0) {
      const uint32_t bar = sm.full + 8 * stage;
      mbar_expect_tx(bar, 2 * STR);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(sm.s0 + stage * STR + j * SBOX, S0, bar, 64 * j, head,
                    row, tl.b);
        tma_load_4d(sm.s1 + stage * STR + j * SBOX, S1, bar, 64 * j, head,
                    row, tl.b);
      }
    }
    if (++stage == STG) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_attn_bwd_kernel(const __grid_constant__ Maps maps, const Args a) {
  using M = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Shared sm;
  sm.r0 = base + ((1024 - (base & 1023)) & 1023);
  sm.r1 = sm.r0 + M::RES;
  sm.s0 = sm.r1 + M::RES;
  sm.s1 = sm.s0 + STAGES * M::STR;
  sm.lse = sm.s1 + STAGES * M::STR;
  sm.delta = sm.lse + STAGES * BS * 4;
  sm.res = sm.delta + STAGES * BS * 4;
  sm.full = sm.res + 8;
  sm.empty = sm.full + 8 * STAGES;

  const Tile tl = tile_of<BQ, BK>(a, a.start + (int)blockIdx.x);
  const Range rg = range_of<BQ, BK, BS>(a, tl);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + (sm.res - base));
    mbar_init(bars, 1);                  // the producer's expect_tx
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 1);        // full: the producer's expect_tx
      mbar_init(bars + 1 + STAGES + s, 8);   // empty: a consumer warp each
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32 && rg.n > 0) {
      if (tl.dq)
        produce<M::NB, STAGES, BS, M::RBOX, M::SBOX>(
            &maps.q_res, &maps.do_res, &maps.k_str, &maps.v_str, a, tl, rg,
            sm);
      else
        produce<M::NB, STAGES, BS, M::RBOX, M::SBOX>(
            &maps.k_res, &maps.v_res, &maps.q_str, &maps.do_str, a, tl, rg,
            sm);
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    if (tl.dq)
      dq_consumer<D>(a, tl, rg, wg, sm);
    else
      dkv_consumer<D>(a, tl, rg, wg, sm);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at head_dim 256: wgmma fed by TMA, the producer warp and two
// consumer warpgroups of the design above, with tiles that fit 256-wide rows
// ---------------------------------------------------------------------------

struct D256 {
  static constexpr int NB = 4;   // 64-wide boxes of a row
  // dQ tile: Q and dO resident (QT rows), K and V streamed in QS-key blocks
  static constexpr int QT = 128, QS = 32, QSTAGES = 3;
  // dK/dV tile: K and V resident (KT keys), Q and dO streamed in KS-row
  // blocks with their rows' lse and delta
  static constexpr int KT = 64, KS = 64, KSTAGES = 2;
  static constexpr int Q_RBOX = QT * 128, Q_SBOX = QS * 128;
  static constexpr int K_RBOX = KT * 128, K_SBOX = KS * 128;
  static constexpr int Q_RES = NB * Q_RBOX, Q_STR = NB * Q_SBOX;
  static constexpr int K_RES = NB * K_RBOX, K_STR = NB * K_SBOX;
  static constexpr int XBUF = KT * KS * 2;   // one block's P^T, bf16
  static constexpr int DQ_BYTES = 2 * Q_RES + 2 * QSTAGES * Q_STR;
  static constexpr int DKV_BYTES = 2 * K_RES + 2 * KSTAGES * K_STR +
                                   2 * XBUF + 2 * KSTAGES * KS * 4;
  static constexpr int TILES = DQ_BYTES > DKV_BYTES ? DQ_BYTES : DKV_BYTES;
  // the larger role's tiles, barriers sized for the deeper ring, alignment
  static constexpr int BYTES = 1024 + TILES + (1 + 2 * QSTAGES) * 8;
};
static_assert(D256::BYTES <= 232448, "227 KB of shared memory a block");
static_assert(D256::KSTAGES <= D256::QSTAGES, "one set of ring barriers");

// named barriers between the dK/dV tile's two consumer warpgroups: P^T of
// buffer b is written (BAR_P + b), and read (BAR_FREE + b)
constexpr int BAR_P = 1, BAR_FREE = 3;

// s[64 x N] = R (64 rows at descriptor dr) * S^T (N rows at ds), both
// K-major over 256 columns in 64-wide boxes of RBOX and SBOX bytes
template <int N, int RBOX, int SBOX>
__device__ __forceinline__ void ss_256(float (&s)[N / 2], uint64_t dr,
                                       uint64_t ds) {
#pragma unroll
  for (int ks = 0; ks < 16; ++ks) {
    const uint64_t a = dr + ((ks / 4) * RBOX + (ks % 4) * 32) / 16;
    const uint64_t b = ds + ((ks / 4) * SBOX + (ks % 4) * 32) / 16;
    if constexpr (N == 32)
      wgmma_m64n32k16_ss<0>(s, a, b, ks > 0);
    else
      wgmma_m64n64k16_ss<0>(s, a, b, ks > 0);
  }
}

// acc[64 x 256] += frag (64 x 16K, registers) * the streamed block at `str`
// (16K x 256, MN-major, 64-wide boxes of SBOX bytes)
template <int K, int SBOX>
__device__ __forceinline__ void rs_256(float (&acc)[128],
                                       const unsigned (&frag)[K][4],
                                       uint32_t str) {
  const uint64_t d = wgmma_desc(str, SBOX, 1024);
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    wgmma_m64n256k16_rs<1>(acc, frag[kk], d + kk * 2048 / 16, 1);
}

// an accumulator of 64 x 16K as K A fragments of bf16
template <int K>
__device__ __forceinline__ void frags_of(unsigned (&f)[K][4],
                                         const float (&s)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// dQ of a warpgroup's 64 query rows (r0 + 64 wg ...): resident Q, dO;
// streamed K, V in blocks of 32 keys
__device__ __forceinline__ void dq_consumer_256(const Args& a, const Tile& tl,
                                                const Range& rg, int wg,
                                                const Shared& sm) {
  using C = D256;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int off = a.Sk - a.Sq;
  const int qw = tl.r0 + wg * 64 + warp * 16;   // the warp's first row
  const long long bh = (long long)tl.b * a.Hq + tl.h;
  float lse2[2], dlt[2];   // rows g and g + 8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const bool in = row < a.Sq;
    lse2[r] = in ? a.lse[bh * a.Sq + row] * LOG2E : INFINITY;
    dlt[r] = in ? a.delta[bh * a.Sq + row] : 0.f;
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  if (rg.n > 0) mbar_wait(sm.res, 0);
  const uint64_t dq_ = wgmma_desc(sm.r0 + wg * 64 * 128, 16, 1024);
  const uint64_t do_ = wgmma_desc(sm.r1 + wg * 64 * 128, 16, 1024);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < rg.n; ++i) {
    const int k0 = (rg.blk0 + i) * C::QS;
    mbar_wait(sm.full + 8 * stage, phase);
    const uint32_t kt = sm.s0 + stage * C::Q_STR, vt = sm.s1 + stage * C::Q_STR;
    float s[16], dp[16];
    wgmma_fence();
    ss_256<32, C::Q_RBOX, C::Q_SBOX>(s, dq_, wgmma_desc(kt, 16, 1024));
    wgmma_commit();
    ss_256<32, C::Q_RBOX, C::Q_SBOX>(dp, do_, wgmma_desc(vt, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = (k0 + C::QS > a.Sk) ||
                      (a.causal && k0 + C::QS - 1 > off + qw) ||
                      (a.window > 0 && k0 <= off + qw + 15 - a.window);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2_approx(s[4 * nt + e] * a.scale_log2e - lse2[r]);
        if (edge && !visible(k0 + nt * 8 + 2 * tq + (e & 1),
                             off + qw + g + 8 * r, a.Sk, a.causal, a.window))
          p = 0.f;
        s[4 * nt + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] *= dp[j] - dlt[(j >> 1) & 1];
    unsigned f[2][4];
    frags_of<2>(f, s);
    wgmma_fence();
    rs_256<2, C::Q_SBOX>(acc, f, kt);   // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(sm.empty + 8 * stage);
    if (++stage == C::QSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<256>(static_cast<bf16*>(a.dq) + tl.b * a.dq_b + tl.h * a.dq_h,
                  a.dq_s, tl.r0 + wg * 64, a.Sq, acc, a.scale);
}

// dV of the dK/dV tile's 64 keys (warpgroup A): S^T = K Q^T and P^T for each
// block of 64 queries; P^T goes to warpgroup B through buffer i % 2 of `xb`
// (fragment order: [4][128 threads] x 16 bytes), then dV += P^T dO
__device__ __forceinline__ void dv_consumer_256(const Args& a, const Tile& tl,
                                                const Range& rg,
                                                const Shared& sm,
                                                uint32_t xb) {
  using C = D256;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int off = a.Sk - a.Sq;
  const int kw = tl.r0 + warp * 16;   // the warp's first key
  float dv[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dv[i] = 0.f;
  if (rg.n > 0) mbar_wait(sm.res, 0);
  const uint64_t k_ = wgmma_desc(sm.r0, 16, 1024);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < rg.n; ++i) {
    const int q0 = (rg.blk0 + i % rg.nq) * C::KS;
    mbar_wait(sm.full + 8 * stage, phase);
    const uint32_t qt = sm.s0 + stage * C::K_STR, ot = sm.s1 + stage * C::K_STR;
    const uint32_t lse2 = sm.lse + stage * C::KS * 4 + tq * 8;
    float st[32];
    wgmma_fence();
    ss_256<64, C::K_RBOX, C::K_SBOX>(st, k_, wgmma_desc(qt, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    const bool edge = (kw + 15 >= a.Sk) || (a.causal && kw + 15 > off + q0) ||
                      (a.window > 0 && kw <= off + q0 + C::KS - 1 - a.window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = ld_shared_f32x2(lse2 + nt * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(st[4 * nt + e] * a.scale_log2e -
                              ((e & 1) ? l2.y : l2.x));
        if (edge && !visible(kw + g + 8 * (e >> 1),
                             off + q0 + nt * 8 + 2 * tq + (e & 1), a.Sk,
                             a.causal, a.window))
          p = 0.f;
        st[4 * nt + e] = p;
      }
    }
    unsigned pf[4][4];
    frags_of<4>(pf, st);
    const int b = i & 1;
    if (i >= 2) named_bar_sync<256>(BAR_FREE + b);   // B has read block i-2's
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(xb + b * C::XBUF + (j * 128 + tid) * 16),
                      "r"(pf[j][0]), "r"(pf[j][1]), "r"(pf[j][2]),
                      "r"(pf[j][3]) : "memory");
    named_bar_arrive<256>(BAR_P + b);
    wgmma_fence();
    rs_256<4, C::K_SBOX>(dv, pf, ot);   // dV += P^T dO
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    if (lane == 0) mbar_arrive(sm.empty + 8 * stage);
    if (++stage == C::KSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<256>(static_cast<bf16*>(a.dv) + tl.b * a.dv_b + tl.h * a.dv_h,
                  a.dv_s, tl.r0, a.Sk, dv, 1.f);
}

// dK of the same 64 keys (warpgroup B): dP^T = V dO^T, P^T from warpgroup A,
// dS^T = P^T (dP^T - delta), dK += dS^T Q
__device__ __forceinline__ void dk_consumer_256(const Args& a, const Tile& tl,
                                                const Range& rg,
                                                const Shared& sm,
                                                uint32_t xb) {
  using C = D256;
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int tq = lane & 3;
  float dk[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dk[i] = 0.f;
  if (rg.n > 0) mbar_wait(sm.res, 0);
  const uint64_t v_ = wgmma_desc(sm.r1, 16, 1024);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < rg.n; ++i) {
    mbar_wait(sm.full + 8 * stage, phase);
    const uint32_t qt = sm.s0 + stage * C::K_STR, ot = sm.s1 + stage * C::K_STR;
    const uint32_t dlt = sm.delta + stage * C::KS * 4 + tq * 8;
    float dpt[32];
    wgmma_fence();
    ss_256<64, C::K_RBOX, C::K_SBOX>(dpt, v_, wgmma_desc(ot, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dpt);
    const int b = i & 1;
    named_bar_sync<256>(BAR_P + b);   // A has written this block's P^T
    unsigned pf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(pf[j][0]), "=r"(pf[j][1]), "=r"(pf[j][2]),
                     "=r"(pf[j][3])
                   : "r"(xb + b * C::XBUF + (j * 128 + tid) * 16)
                   : "memory");
    if (i + 2 < rg.n) named_bar_arrive<256>(BAR_FREE + b);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d2 = ld_shared_f32x2(dlt + nt * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned w = pf[nt / 2][2 * (nt % 2) + (e >> 1)];
        const float p = __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
        dpt[4 * nt + e] = p * (dpt[4 * nt + e] - ((e & 1) ? d2.y : d2.x));
      }
    }
    unsigned sf[4][4];
    frags_of<4>(sf, dpt);
    wgmma_fence();
    rs_256<4, C::K_SBOX>(dk, sf, qt);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    if (lane == 0) mbar_arrive(sm.empty + 8 * stage);
    if (++stage == C::KSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<256>(static_cast<bf16*>(a.dk) + tl.b * a.dk_b + tl.h * a.dk_h,
                  a.dk_s, tl.r0, a.Sk, dk, a.scale);
}

__global__ void __launch_bounds__(NTHREADS, 1)
bwd_d256_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = D256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t t0 = base + ((1024 - (base & 1023)) & 1023);
  const Tile tl = tile_of<C::QT, C::KT>(a, a.start + (int)blockIdx.x);
  Shared sm;
  uint32_t xb = 0;
  Range rg;
  sm.r0 = t0;
  if (tl.dq) {
    rg = range_of<C::QT, C::KT, C::QS>(a, tl);
    sm.r1 = sm.r0 + C::Q_RES;
    sm.s0 = sm.r1 + C::Q_RES;
    sm.s1 = sm.s0 + C::QSTAGES * C::Q_STR;
    sm.lse = sm.delta = 0;
  } else {
    rg = range_of<C::QT, C::KT, C::KS>(a, tl);
    sm.r1 = sm.r0 + C::K_RES;
    sm.s0 = sm.r1 + C::K_RES;
    sm.s1 = sm.s0 + C::KSTAGES * C::K_STR;
    xb = sm.s1 + C::KSTAGES * C::K_STR;
    sm.lse = xb + 2 * C::XBUF;
    sm.delta = sm.lse + C::KSTAGES * C::KS * 4;
  }
  sm.res = t0 + C::TILES;
  sm.full = sm.res + 8;
  sm.empty = sm.full + 8 * C::QSTAGES;
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + (sm.res - base));
    mbar_init(bars, 1);
    for (int s = 0; s < C::QSTAGES; ++s) {
      mbar_init(bars + 1 + s, 1);
      mbar_init(bars + 1 + C::QSTAGES + s, 8);   // a consumer warp each
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32 && rg.n > 0) {
      if (tl.dq)
        produce<C::NB, C::QSTAGES, C::QS, C::Q_RBOX, C::Q_SBOX>(
            &maps.q_res, &maps.do_res, &maps.k_str, &maps.v_str, a, tl, rg,
            sm);
      else
        produce<C::NB, C::KSTAGES, C::KS, C::K_RBOX, C::K_SBOX>(
            &maps.k_res, &maps.v_res, &maps.q_str, &maps.do_str, a, tl, rg,
            sm);
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    if (tl.dq)
      dq_consumer_256(a, tl, rg, wg, sm);
    else if (wg == 0)
      dv_consumer_256(a, tl, rg, sm, xb);
    else
      dk_consumer_256(a, tl, rg, sm, xb);
  }
}

// ---------------------------------------------------------------------------
// float32: split TF32 on the tensor cores (mma.sync m16n8k8), tiles staged by
// cp.async from the model's layout and split once as they land
// ---------------------------------------------------------------------------

struct In {   // the inputs' base pointers and strides, in elements
  const void *q, *k, *v, *dout;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h;
};

template <typename T>
__device__ __forceinline__ const T* head_base(const void* p, long long sb,
                                              long long sh, int b, int h) {
  return static_cast<const T*>(p) + b * sb + h * sh;
}

// A streamed block of R rows is two planes [R][P] of f32 words: hi =
// tf32(x), then lo = x - hi truncated, split once as it lands.  A resident
// tile is one plane as loaded, split in registers as its fragments load: its
// fragments are read again for every streamed block, and shared-memory
// reads cost more here than the four ALU operations of a split (hi and lo
// planes of the resident tile, 64-row tiles and 8-row parts of each block:
// 3.92 ms against 3.05 at olmo-1b's shape in one call, NVIDIA H100 80GB
// HBM3, 700 W).  The landed blocks take the capped rounding (`tf32_rna`);
// the resident tile takes it only if it holds a finite value the cap
// rounds (`tf32_needs_cap`, once a tile), else the bare rounding, the same
// bits: the cap's two more operations in the fragments' split cost 4.5 %
// at olmo-1b's shape in one call, NVIDIA H100 80GB HBM3, 700 W.  P and dS,
// computed, take the bare one.  Every warp owns 16 rows of the tile (a row
// group); at head_dim 256 a dQ warp takes a part of each streamed block and
// a dK/dV warp a part of the columns (its dK and dV would take 256
// registers), and the parts' sums meet in shared memory at the end, added
// in part order.
template <int D>
struct F32 {
  static constexpr int P = D + 4;                // floats a plane row
  static constexpr int T = D == 256 ? 32 : 128;  // rows of either tile
  static constexpr int SB = D == 64 ? 32 : 16;   // rows of a streamed block
  static constexpr int NW = D == 256 ? 4 : 8;    // warps
  static constexpr int RG = T / 16;              // row groups
  static constexpr int SQ = NW / RG;             // dQ: parts of a block
  static constexpr int CK = NW / RG;             // dK/dV: parts of the columns
  static constexpr int KC = 2;                   // accumulators of a score
  static constexpr int RES = T * P;              // floats of a resident operand
  static constexpr int STR = 2 * SB * P;         // floats of a streamed operand
  // resident pair, a ring of two streamed pairs, lse and delta a stage
  static constexpr int BYTES = 4 * (2 * RES + 4 * STR + 4 * SB);
};
template <int D>
constexpr bool f32_fits() {   // the tiles, and the dQ parts' sums in the ring
  using F = F32<D>;
  return F::BYTES <= 232448 &&
         (F::SQ - 1) * F::RG * (D / 8) * 128 <= 4 * F::STR &&
         D / F::CK <= 128;   // a dK/dV warp's dK and dV: 2 x D/CK / 2 registers
}
static_assert(f32_fits<64>() && f32_fits<128>() && f32_fits<256>(),
              "227 KB of shared memory a block");

// rows [row0, row0 + R) of a [*, D] f32 operand -> rows of pitch P at
// `dst` (zero-filled at or past `limit`); thread i takes 16-byte chunks i,
// i + NT, ... (and `split_rows` later splits the same chunks)
template <int D, int R, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int limit) {
  tf32_load_rows<D, F32<D>::P, R, NT>(dst, src, stride, row0, limit);
}

// a streamed operand's R rows -> the lo plane of its tile at `t`
template <int D, int R, int NT>
__device__ __forceinline__ void load_block(float* t, const float* src,
                                           long long stride, int row0,
                                           int limit) {
  load_rows<D, R, NT>(t + R * F32<D>::P, src, stride, row0, limit);
}

// this thread's landed chunks of the tile at `t`: x -> hi, lo in place
template <int D, int R, int NT>
__device__ __forceinline__ void split_rows(float* t) {
  tf32_split_rows<R, D, F32<D>::P, NT>(t);
}

// The split's fragment loaders and `mma3` are in tensor_core.cuh.  Chains
// are kept short there (the tensor cores round each addition toward zero):
// a score's D columns go to KC accumulators summed in f32 at the end, and
// each streamed block's share of an output goes to a fresh accumulator
// added to the running one on the CUDA cores, rounding to nearest.

// s0 = rows of the raw resident plane a0 times rows of the streamed planes
// at b0 (hi; lo BR rows on), and s1 likewise of a1 and b1: two scores [16 x
// 8NS] over d < D, taken in one loop so their chains overlap
template <int D, int BR, int NS, bool CAP>
__device__ __forceinline__ void scores(float (&s0)[NS][4], float (&s1)[NS][4],
                                       const float* a0, const float* b0,
                                       const float* a1, const float* b1,
                                       int g, int t) {
  constexpr int P = F32<D>::P, KC = F32<D>::KC;
  float c0[KC][NS][4], c1[KC][NS][4];
#pragma unroll
  for (int q = 0; q < KC; ++q)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) c0[q][n][j] = c1[q][n][j] = 0.f;
#pragma unroll 2
  for (int k1 = 0; k1 < D; k1 += 8 * KC)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      const int k0 = k1 + 8 * q;
      unsigned ah[4], al[4], ch[4], cl[4];
      frag_a<P, CAP>(ah, al, a0, k0, g, t);
      frag_a<P, CAP>(ch, cl, a1, k0, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        unsigned bh[2], bl[2], dh[2], dl[2];
        frag_b_nk<P>(bh, b0 + n * 8 * P, k0, g, t);
        frag_b_nk<P>(bl, b0 + (BR + n * 8) * P, k0, g, t);
        frag_b_nk<P>(dh, b1 + n * 8 * P, k0, g, t);
        frag_b_nk<P>(dl, b1 + (BR + n * 8) * P, k0, g, t);
        mma3(c0[q][n], ah, al, bh, bl);
        mma3(c1[q][n], ch, cl, dh, dl);
      }
    }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s0[n][j] = c0[0][n][j];
      s1[n][j] = c1[0][n][j];
#pragma unroll
      for (int q = 1; q < KC; ++q) {
        s0[n][j] += c0[q][n][j];
        s1[n][j] += c1[q][n][j];
      }
    }
}

// acc[16 x 8NO] += c (16 x 8NS, accumulator tiles) * rows 0 .. 8NS of the
// streamed planes (b: hi, b + BR*P: lo), columns c0 ... c0 + 8NO; with
// NA = 2 also acc1 += c1 * the planes at b1, in the same loop
template <int D, int BR, int NS, int NO, int NA = 1>
__device__ __forceinline__ void accumulate(float (&acc)[NO][4],
                                           const float (&c)[NS][4],
                                           const float* b,
                                           float (&acc1)[NO][4],
                                           const float (&c1)[NS][4],
                                           const float* b1, int c0, int g,
                                           int t) {
  constexpr int P = F32<D>::P;
  unsigned ah[NA][NS][4], al[NA][NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    frag_of_acc(ah[0][n], al[0][n], c[n]);
    if constexpr (NA == 2) frag_of_acc(ah[NA - 1][n], al[NA - 1][n], c1[n]);
  }
#pragma unroll
  for (int m = 0; m < NO; ++m) {
    float x[NA][4];   // this block's share
#pragma unroll
    for (int u = 0; u < NA; ++u) x[u][0] = x[u][1] = x[u][2] = x[u][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int u = 0; u < NA; ++u) {
        const float* p = u == 0 ? b : b1;
        unsigned bh[2], bl[2];
        frag_b_kn_acc<P>(bh, p + n * 8 * P, c0 + m * 8, g, t);
        frag_b_kn_acc<P>(bl, p + (BR + n * 8) * P, c0 + m * 8, g, t);
        mma3(x[u], ah[u][n], al[u][n], bh, bl);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[m][j] += x[0][j];
      if constexpr (NA == 2) acc1[m][j] += x[NA - 1][j];
    }
  }
}

// adds the dQ accumulators of a row group's parts 1.. to part 0's, in part
// order, through `scratch` (the ring, no longer read); every thread calls it
template <int NO>
__device__ __forceinline__ void sum_parts(float (&acc)[NO][4], float* scratch,
                                          int part, int parts, int slot,
                                          int slots, int lane) {
  if (parts == 1) return;
  __syncthreads();
  if (part > 0) {
    float* p = scratch + ((part - 1) * slots + slot) * NO * 128 + lane;
#pragma unroll
    for (int m = 0; m < NO; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[(4 * m + j) * 32] = acc[m][j];
  }
  __syncthreads();
  if (part == 0)
    for (int q = 1; q < parts; ++q) {
      const float* p = scratch + ((q - 1) * slots + slot) * NO * 128 + lane;
#pragma unroll
      for (int m = 0; m < NO; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += p[(4 * m + j) * 32];
    }
}

// rows r0 + g, r0 + g + 8 of accumulator tiles acc[m] (columns c0 + 8m ...),
// times `mul`, below `limit`, into out[b, row, h, :]
template <int NO>
__device__ __forceinline__ void store_acc(void* out, long long sb,
                                          long long ss, long long sh, int b,
                                          int h, int r0, int c0, int limit,
                                          const float (&acc)[NO][4],
                                          float mul, int g, int t) {
  float* base = static_cast<float*>(out) + b * sb + h * sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < limit)
#pragma unroll
      for (int m = 0; m < NO; ++m)
        *reinterpret_cast<float2*>(base + row * ss + c0 + m * 8 + 2 * t) =
            make_float2(acc[m][2 * r] * mul, acc[m][2 * r + 1] * mul);
  }
}

// dQ of T query rows of one head: warp w owns rows 16 (w % RG) ... and keys
// [SW part, SW part + SW) of each streamed block of SB keys
template <int D>
__device__ __forceinline__ void dq_tf32(const Args& a, const In& in,
                                        const Tile& tl, const Range& rg,
                                        float* sm) {
  using F = F32<D>;
  constexpr int P = F::P, T = F::T, SB = F::SB, NT = F::NW * 32;
  constexpr int SW = SB / F::SQ, NS = SW / 8, NO = D / 8;
  float* rq = sm;             // Q, as loaded
  float* ro = rq + F::RES;    // dO
  float* ring = ro + F::RES;  // [stage]: K (hi, lo), V (hi, lo)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % F::RG, part = warp / F::RG;
  const int off = a.Sk - a.Sq, hk = tl.h / a.G;
  const int qw = tl.r0 + grp * 16;   // the warp's first row
  const long long bh = (long long)tl.b * a.Hq + tl.h;
  float lse[2], dlt[2];   // rows g and g + 8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    lse[r] = row < a.Sq ? a.lse[bh * a.Sq + row] : INFINITY;
    dlt[r] = row < a.Sq ? a.delta[bh * a.Sq + row] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int m = 0; m < NO; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
  const float* kb = head_base<float>(in.k, in.k_b, in.k_h, tl.b, hk);
  const float* vb = head_base<float>(in.v, in.v_b, in.v_h, tl.b, hk);
  if (rg.n > 0) {
    load_rows<D, T, NT>(rq, head_base<float>(in.q, in.q_b, in.q_h, tl.b, tl.h),
                        in.q_s, tl.r0, a.Sq);
    load_rows<D, T, NT>(ro, head_base<float>(in.dout, in.do_b, in.do_h, tl.b,
                                             tl.h), in.do_s, tl.r0, a.Sq);
    load_block<D, SB, NT>(ring, kb, in.k_s, rg.blk0 * SB, a.Sk);
    load_block<D, SB, NT>(ring + F::STR, vb, in.v_s, rg.blk0 * SB, a.Sk);
    cp_async_commit();
  }
  bool cap = false;   // whether the resident pair needs the capped rounding
  for (int i = 0; i < rg.n; ++i) {
    float* ks = ring + (i & 1) * 2 * F::STR;
    float* vs = ks + F::STR;
    cp_async_wait<0>();   // this thread's chunks of block i have landed
    if (i == 0)           // and of the resident pair
      cap = tf32_needs_cap<T, D, P, NT>(rq) || tf32_needs_cap<T, D, P, NT>(ro);
    split_rows<D, SB, NT>(ks);
    split_rows<D, SB, NT>(vs);
    // block i is split; block i - 1 is no longer read
    cap = __syncthreads_or(cap);
    if (i + 1 < rg.n) {
      float* nk = ring + ((i + 1) & 1) * 2 * F::STR;
      const int k1 = (rg.blk0 + i + 1) * SB;
      load_block<D, SB, NT>(nk, kb, in.k_s, k1, a.Sk);
      load_block<D, SB, NT>(nk + F::STR, vb, in.v_s, k1, a.Sk);
      cp_async_commit();
    }
    const int kp = (rg.blk0 + i) * SB + part * SW;   // the warp's first key
    float s[NS][4], dp[NS][4];
    if (cap)
      scores<D, SB, NS, true>(s, dp, rq + grp * 16 * P, ks + part * SW * P,
                              ro + grp * 16 * P, vs + part * SW * P, g, t);
    else
      scores<D, SB, NS, false>(s, dp, rq + grp * 16 * P, ks + part * SW * P,
                               ro + grp * 16 * P, vs + part * SW * P, g, t);
    const bool edge = (kp + SW > a.Sk) || (a.causal && kp + SW - 1 > off + qw) ||
                      (a.window > 0 && kp <= off + qw + 15 - a.window);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = expf(s[n][e] * a.scale - lse[r]);
        if (edge && !visible(kp + n * 8 + 2 * t + (e & 1), off + qw + g + 8 * r,
                             a.Sk, a.causal, a.window))
          p = 0.f;
        s[n][e] = p * (dp[n][e] - dlt[r]);   // dS
      }
    accumulate<D, SB, NS, NO>(acc, s, ks + part * SW * P, acc, s, nullptr, 0,
                              g, t);   // dQ += dS K
  }
  sum_parts<NO>(acc, ring, part, F::SQ, grp, F::RG, lane);
  if (part == 0)
    store_acc<NO>(a.dq, a.dq_b, a.dq_s, a.dq_h, tl.b, tl.h, qw, 0, a.Sq, acc,
                  a.scale, g, t);
}

// dK and dV of T keys of one KV head: warp w owns keys 16 (w % RG) ... and
// columns [DC (w / RG), + DC) over each streamed block of SB queries (of the
// G query heads in turn)
template <int D>
__device__ __forceinline__ void dkv_tf32(const Args& a, const In& in,
                                         const Tile& tl, const Range& rg,
                                         float* sm) {
  using F = F32<D>;
  constexpr int P = F::P, T = F::T, SB = F::SB, NT = F::NW * 32;
  constexpr int NS = SB / 8, DC = D / F::CK, NO = DC / 8;
  float* rk = sm;             // K, as loaded
  float* rv = rk + F::RES;    // V
  float* ring = rv + F::RES;  // [stage]: Q (hi, lo), dO (hi, lo)
  float* sl = ring + 4 * F::STR;   // [stage][SB]: the block's rows' lse
  float* sd = sl + 2 * SB;         // ... and delta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % F::RG;
  const int c0 = (warp / F::RG) * DC;   // the warp's first column
  const int off = a.Sk - a.Sq;
  const int kw = tl.r0 + grp * 16;   // the warp's first key
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int m = 0; m < NO; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[m][j] = dv[m][j] = 0.f;
  // streamed block j: query rows [q0, q0 + SB) of query head `head`
  auto stage_block = [&](int j, int stage) {
    const int head = tl.h * a.G + j / rg.nq;
    const int q0 = (rg.blk0 + j % rg.nq) * SB;
    float* qs = ring + stage * 2 * F::STR;
    load_block<D, SB, NT>(qs, head_base<float>(in.q, in.q_b, in.q_h, tl.b,
                                               head), in.q_s, q0, a.Sq);
    load_block<D, SB, NT>(qs + F::STR, head_base<float>(in.dout, in.do_b,
                                                        in.do_h, tl.b, head),
                          in.do_s, q0, a.Sq);
    cp_async_commit();
    if (threadIdx.x < SB) {
      const int row = q0 + threadIdx.x;
      const long long bh = (long long)tl.b * a.Hq + head;
      sl[stage * SB + threadIdx.x] = row < a.Sq ? a.lse[bh * a.Sq + row] : INFINITY;
      sd[stage * SB + threadIdx.x] = row < a.Sq ? a.delta[bh * a.Sq + row] : 0.f;
    }
  };
  if (rg.n > 0) {
    load_rows<D, T, NT>(rk, head_base<float>(in.k, in.k_b, in.k_h, tl.b, tl.h),
                        in.k_s, tl.r0, a.Sk);
    load_rows<D, T, NT>(rv, head_base<float>(in.v, in.v_b, in.v_h, tl.b, tl.h),
                        in.v_s, tl.r0, a.Sk);
    stage_block(0, 0);
  }
  bool cap = false;   // whether the resident pair needs the capped rounding
  for (int i = 0; i < rg.n; ++i) {
    const int stage = i & 1;
    float* qs = ring + stage * 2 * F::STR;
    float* os = qs + F::STR;
    cp_async_wait<0>();
    if (i == 0)
      cap = tf32_needs_cap<T, D, P, NT>(rk) || tf32_needs_cap<T, D, P, NT>(rv);
    split_rows<D, SB, NT>(qs);
    split_rows<D, SB, NT>(os);
    // block i is split; block i - 1 is no longer read
    cap = __syncthreads_or(cap);
    if (i + 1 < rg.n) stage_block(i + 1, stage ^ 1);
    const int q0 = (rg.blk0 + i % rg.nq) * SB;   // the block's first query
    const float* ls = sl + stage * SB;
    const float* ds = sd + stage * SB;
    float st[NS][4], dpt[NS][4];   // S^T, dP^T: 16 keys x SB queries
    if (cap)
      scores<D, SB, NS, true>(st, dpt, rk + grp * 16 * P, qs,
                              rv + grp * 16 * P, os, g, t);
    else
      scores<D, SB, NS, false>(st, dpt, rk + grp * 16 * P, qs,
                               rv + grp * 16 * P, os, g, t);
    const bool edge = (kw + 15 >= a.Sk) || (a.causal && kw + 15 > off + q0) ||
                      (a.window > 0 && kw <= off + q0 + SB - 1 - a.window);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float p = expf(st[n][e] * a.scale - ls[col]);
        if (edge && !visible(kw + g + 8 * (e >> 1), off + q0 + col, a.Sk,
                             a.causal, a.window))
          p = 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - ds[col]);
      }
    // dV += P^T dO, dK += dS^T Q
    accumulate<D, SB, NS, NO, 2>(dv, st, os, dk, dpt, qs, c0, g, t);
  }
  store_acc<NO>(a.dk, a.dk_b, a.dk_s, a.dk_h, tl.b, tl.h, kw, c0, a.Sk, dk,
                a.scale, g, t);
  store_acc<NO>(a.dv, a.dv_b, a.dv_s, a.dv_h, tl.b, tl.h, kw, c0, a.Sk, dv,
                1.f, g, t);
}

template <int D>
__global__ void __launch_bounds__(F32<D>::NW * 32, 1)
bwd_tf32_kernel(const Args a, const In in) {
  using F = F32<D>;
  extern __shared__ __align__(16) float fsm[];
  const Tile tl = tile_of<F::T, F::T>(a, a.start + (int)blockIdx.x);
  const Range rg = range_of<F::T, F::T, F::SB>(a, tl);
  if (tl.dq)
    dq_tf32<D>(a, in, tl, rg, fsm);
  else
    dkv_tf32<D>(a, in, tl, rg, fsm);
}

// delta[row] = sum_d dO[row, d] * O[row, d] (f32), row = (b*Hq + h)*Sq + s;
// one warp a row
__device__ __forceinline__ float2 pair_f32(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int Hq, int Sq, int D,
             long long o_b, long long o_s, long long o_h, long long do_b,
             long long do_s, long long do_h) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = row % Sq, bh = row / Sq, b = bh / Hq, h = bh % Hq;
  const T* op = o + b * o_b + s * o_s + h * o_h;
  const T* dp = dout + b * do_b + s * do_s + h * do_h;
  float acc = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 x = pair_f32(op + d), y = pair_f32(dp + d);
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

// a [B, S, H, D] bf16 operand as a 4-D map {D, H, S, B}: boxes of 64
// head-dim values x 1 head x `rows` rows
int encode_operand(CUtensorMap* map, const void* base, int B, int S, int H,
                   int D, long long s_b, long long s_s, long long s_h,
                   int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)s_h * 2, (uint64_t)s_s * 2,
                               (uint64_t)s_b * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return encode_bf16_map(map, base, 4, dims, strides, box);
}

// a kernel taking more than 48 KB of shared memory: opt in, then launch
template <typename Kernel, typename... A>
int launch_with(Kernel kernel, int smem, int num_tiles, int threads,
                cudaStream_t stream, const A&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// the paths: 1 = bf16 wgmma (head_dim 64, 128), 2 = bf16 wgmma at 256,
// 3 = f32 split TF32 (64, 128, 256); 0 = not taken
int path_of(int dtype, int D) {
  if (dtype == 1) return D == 64 || D == 128 ? 1 : D == 256 ? 2 : 0;
  if (dtype == 0) return D == 64 || D == 128 || D == 256 ? 3 : 0;
  return 0;
}

int f32_tile(int D) {
  return D == 64 ? F32<64>::T : D == 128 ? F32<128>::T : F32<256>::T;
}

template <int D>
int launch_tf32(const Args& a, const In& in, int num_tiles,
                cudaStream_t stream) {
  return launch_with(bwd_tf32_kernel<D>, F32<D>::BYTES, num_tiles,
                     F32<D>::NW * 32, stream, a, in);
}

}  // namespace

// Query rows of a dQ tile and keys of a dK/dV tile of the path that takes
// (dtype, D), or -1 if none does; the wrapper sizes the tile space with them.
extern "C" int flash_attention_bwd_block_q(int dtype, int D) {
  const int p = path_of(dtype, D);
  return p == 1 ? BQ : p == 2 ? D256::QT : p == 3 ? f32_tile(D) : -1;
}
extern "C" int flash_attention_bwd_block_k(int dtype, int D) {
  const int p = path_of(dtype, D);
  return p == 1 ? BK : p == 2 ? D256::KT : p == 3 ? f32_tile(D) : -1;
}

// delta [B, Hq, Sq] f32 (contiguous) = rowsum(dO * O); o, dout [B,Sq,Hq,D]
// bf16 or f32 (dtype 1 or 0), strides in elements.  Returns the CUDA error
// of the launch, or -1 for a shape or type the kernel does not take.
extern "C" int flash_attention_bwd_delta(
    const void* o, const void* dout, void* delta, int B, int Hq, int Sq,
    int D, int dtype, long long o_b, long long o_s, long long o_h,
    long long do_b, long long do_s, long long do_h, void* stream) {
  if (path_of(dtype, D) == 0) return -1;
  const int rows = B * Hq * Sq;
  if (rows <= 0) return 0;
  const int grid = (rows + 7) / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    delta_kernel<bf16><<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), rows, Hq, Sq, D, o_b, o_s, o_h, do_b,
        do_s, do_h);
  else
    delta_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows, Hq, Sq, D, o_b, o_s, o_h, do_b,
        do_s, do_h);
  return (int)cudaGetLastError();
}

// Tiles [start, start+num_tiles) of the backward's flat tile space: dQ tiles
// (B*Hq) x n_qblocks first, then dK/dV tiles (B*Hq/G) x ceil(Sk/block_k),
// numbered as `tile_of` says at the path's blocks, written in place into dq
// [B,Sq,Hq,D] and dk, dv [B,Sk,Hk,D].  q, dout [B,Sq,Hq,D]; k, v
// [B,Sk,Hk,D]; lse, delta [B,Hq,Sq] f32 contiguous (lse in natural base,
// +inf for a row that sees no key).  Masks as the forward's: qpos = Sk - Sq
// + row sees kpos if kpos < Sk, kpos <= qpos (causal) and kpos > qpos -
// window (window > 0).  Strides in elements, last stride 1.  Returns the
// CUDA error of the launch (0 = success), -1 for a shape or type the kernel
// does not take (bfloat16 or float32 at head_dim 64, 128 or 256 only), or
// -2 if a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_atom(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int start, int num_tiles, int n_qblocks, int B, int Hq,
    int G, int Sq, int Sk, int D, int causal, int window, int dtype,
    long long q_b, long long q_s, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long do_b, long long do_s, long long do_h,
    long long dq_b, long long dq_s, long long dq_h,
    long long dk_b, long long dk_s, long long dk_h,
    long long dv_b, long long dv_s, long long dv_h, void* stream) {
  const int path = path_of(dtype, D);
  if (path == 0) return -1;
  if (num_tiles <= 0) return 0;
  const int Hk = Hq / G;
  Args a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.start = start;
  a.BH = B * Hq;
  a.BHk = B * Hk;
  a.n_dq_tiles = a.BH * n_qblocks;
  a.n_qblocks = n_qblocks;
  a.Hq = Hq;
  a.G = G;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.dq_b = dq_b; a.dq_s = dq_s; a.dq_h = dq_h;
  a.dk_b = dk_b; a.dk_s = dk_s; a.dk_h = dk_h;
  a.dv_b = dv_b; a.dv_s = dv_s; a.dv_h = dv_h;
  a.scale = 1.f / sqrtf((float)D);
  a.scale_log2e = LOG2E * a.scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 3) {
    const In in = {q, k, v, dout, q_b, q_s, q_h, k_b, k_s, k_h,
                   v_b, v_s, v_h, do_b, do_s, do_h};
    return D == 64 ? launch_tf32<64>(a, in, num_tiles, s)
         : D == 128 ? launch_tf32<128>(a, in, num_tiles, s)
                    : launch_tf32<256>(a, in, num_tiles, s);
  }
  // rows of the boxes: resident and streamed, query side and key side
  const bool wide = path == 2;
  const int q_res = wide ? D256::QT : BR, q_str = wide ? D256::KS : BS;
  const int kv_res = wide ? D256::KT : BR, kv_str = wide ? D256::QS : BS;
  Maps m;
  if (int e = encode_operand(&m.q_res, q, B, Sq, Hq, D, q_b, q_s, q_h, q_res))
    return e;
  if (int e = encode_operand(&m.do_res, dout, B, Sq, Hq, D, do_b, do_s, do_h,
                             q_res))
    return e;
  if (int e = encode_operand(&m.q_str, q, B, Sq, Hq, D, q_b, q_s, q_h, q_str))
    return e;
  if (int e = encode_operand(&m.do_str, dout, B, Sq, Hq, D, do_b, do_s, do_h,
                             q_str))
    return e;
  if (int e = encode_operand(&m.k_res, k, B, Sk, Hk, D, k_b, k_s, k_h, kv_res))
    return e;
  if (int e = encode_operand(&m.v_res, v, B, Sk, Hk, D, v_b, v_s, v_h, kv_res))
    return e;
  if (int e = encode_operand(&m.k_str, k, B, Sk, Hk, D, k_b, k_s, k_h, kv_str))
    return e;
  if (int e = encode_operand(&m.v_str, v, B, Sk, Hk, D, v_b, v_s, v_h, kv_str))
    return e;
  if (wide)
    return launch_with(bwd_d256_kernel, D256::BYTES, num_tiles, NTHREADS, s,
                       m, a);
  return D == 64 ? launch_with(flash_attn_bwd_kernel<64>, Smem<64>::BYTES,
                               num_tiles, NTHREADS, s, m, a)
                 : launch_with(flash_attn_bwd_kernel<128>, Smem<128>::BYTES,
                               num_tiles, NTHREADS, s, m, a);
}
