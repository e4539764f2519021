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
// slower); the outputs are stored from registers as bf16 pairs.  bfloat16 at
// head_dim 64 and 128 only; float32 and head_dim 256 return -1 (ROADMAP B4).
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
  bf16 *dq, *dk, *dv;
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
  static constexpr int RES_TX = 2 * RES;        // bytes of the resident pair
  static constexpr int STR_TX = 2 * STR;        // bytes of a streamed pair
  // resident pair, the two rings, lse / delta a stage, barriers, and room to
  // align the tiles to 1024 bytes
  static constexpr int BYTES = 1024 + 2 * RES + 2 * STAGES * STR +
                               2 * STAGES * BS * 4 + (1 + 2 * STAGES) * 8;
};
static_assert(Smem<128>::BYTES <= 232448, "227 KB of shared memory a block");

// the tile of flat index t: a dQ tile (b, q head, first query row) or a
// dK/dV tile (b, KV head, first key); heaviest causal blocks first
struct Tile {
  bool dq;
  int b, h, r0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  if (t < a.n_dq_tiles) {
    const int bh = t % a.BH, qi = a.n_qblocks - 1 - t / a.BH;
    return {true, bh / a.Hq, bh % a.Hq, qi * BQ};
  }
  const int u = t - a.n_dq_tiles, Hk = a.Hq / a.G;
  const int bhk = u % a.BHk;
  return {false, bhk / Hk, bhk % Hk, (u / a.BHk) * BK};
}

// the streamed blocks a tile takes: [blk0, blk0 + n) of BS keys (dQ tile),
// or n = G * nq blocks, query blocks [blk0, blk0 + nq) of each head of the
// group in order (dK/dV tile)
struct Range {
  int blk0, nq, n;
};

__device__ __forceinline__ Range range_of(const Args& a, const Tile& tl) {
  const int off = a.Sk - a.Sq;   // qpos = off + query row
  int lo, hi;
  if (tl.dq) {
    const int q_last = min(tl.r0 + BQ, a.Sq) - 1;
    hi = a.causal ? min(a.Sk, off + q_last + 1) : a.Sk;
    lo = a.window > 0 ? max(0, off + tl.r0 - a.window + 1) : 0;
  } else {   // the query rows that see any key of this tile
    const int kv_last = min(tl.r0 + BK, a.Sk) - 1;
    lo = a.causal ? max(0, tl.r0 - off) : 0;
    hi = a.window > 0 ? min(a.Sq, kv_last + a.window - off) : a.Sq;
  }
  Range r;
  r.blk0 = lo / BS;
  r.nq = hi > lo ? (hi + BS - 1) / BS - r.blk0 : 0;
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
  store_rows<D>(a.dq + tl.b * a.dq_b + tl.h * a.dq_h, a.dq_s, tl.r0 + wg * 64,
                a.Sq, acc, a.scale);
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
  store_rows<D>(a.dk + tl.b * a.dk_b + tl.h * a.dk_h, a.dk_s, tl.r0 + wg * 64,
                a.Sk, dk, a.scale);
  store_rows<D>(a.dv + tl.b * a.dv_b + tl.h * a.dv_h, a.dv_s, tl.r0 + wg * 64,
                a.Sk, dv, 1.f);
}

// the producer warp: the resident pair once, then every streamed block of the
// tile through the ring (for a dK/dV tile with its rows' lse * log2 e and
// delta, +inf and 0 past Sq, staged by the warp's 32 lanes).  R and S are
// the maps of the resident and the streamed operands.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* R0,
                                        const CUtensorMap* R1,
                                        const CUtensorMap* S0,
                                        const CUtensorMap* S1, const Args& a,
                                        const Tile& tl, const Range& rg,
                                        const Shared& sm) {
  using M = Smem<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect_tx(sm.res, M::RES_TX);
#pragma unroll
    for (int j = 0; j < M::NB; ++j) {
      tma_load_4d(sm.r0 + j * M::RBOX, R0, sm.res, 64 * j, tl.h, tl.r0, tl.b);
      tma_load_4d(sm.r1 + j * M::RBOX, R1, sm.res, 64 * j, tl.h, tl.r0, tl.b);
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < rg.n; ++i) {
    int head, row;
    if (tl.dq) {
      head = tl.h / a.G;
      row = (rg.blk0 + i) * BS;
    } else {
      head = tl.h * a.G + i / rg.nq;
      row = (rg.blk0 + i % rg.nq) * BS;
    }
    mbar_wait(sm.empty + 8 * stage, phase ^ 1);
    if (!tl.dq) {
      const long long base = ((long long)tl.b * a.Hq + head) * a.Sq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * lane + e, rr = row + c;
        const bool in = rr < a.Sq;
        st_shared_f32(sm.lse + (stage * BS + c) * 4,
                      in ? a.lse[base + rr] * LOG2E : INFINITY);
        st_shared_f32(sm.delta + (stage * BS + c) * 4,
                      in ? a.delta[base + rr] : 0.f);
      }
      __syncwarp();
    }
    if (lane == 0) {
      const uint32_t bar = sm.full + 8 * stage;
      mbar_expect_tx(bar, M::STR_TX);
#pragma unroll
      for (int j = 0; j < M::NB; ++j) {
        tma_load_4d(sm.s0 + stage * M::STR + j * M::SBOX, S0, bar, 64 * j,
                    head, row, tl.b);
        tma_load_4d(sm.s1 + stage * M::STR + j * M::SBOX, S1, bar, 64 * j,
                    head, row, tl.b);
      }
    }
    if (++stage == STAGES) {
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

  const Tile tl = tile_of(a, a.start + (int)blockIdx.x);
  const Range rg = range_of(a, tl);
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
        produce<D>(&maps.q_res, &maps.do_res, &maps.k_str, &maps.v_str, a, tl,
                   rg, sm);
      else
        produce<D>(&maps.k_res, &maps.v_res, &maps.q_str, &maps.do_str, a, tl,
                   rg, sm);
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

// delta[row] = sum_d dO[row, d] * O[row, d] (f32), row = (b*Hq + h)*Sq + s;
// one warp a row
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, int rows, int Hq, int Sq, int D,
             long long o_b, long long o_s, long long o_h, long long do_b,
             long long do_s, long long do_h) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = row % Sq, bh = row / Sq, b = bh / Hq, h = bh % Hq;
  const bf16* op = o + b * o_b + s * o_s + h * o_h;
  const bf16* dp = dout + b * do_b + s * do_s + h * do_h;
  float acc = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + d));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dp + d));
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

template <int D>
int launch(const Maps& m, const Args& a, int num_tiles, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;   // above 48 KB: dynamic, opted in
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  flash_attn_bwd_kernel<D><<<num_tiles, NTHREADS, smem, stream>>>(m, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Query rows of a dQ tile and keys of a dK/dV tile; the wrapper sizes the
// tile space with them.
extern "C" int flash_attention_bwd_block_q() { return BQ; }
extern "C" int flash_attention_bwd_block_k() { return BK; }

// delta [B, Hq, Sq] f32 (contiguous) = rowsum(dO * O); o, dout [B,Sq,Hq,D]
// bf16, strides in elements.  Returns the CUDA error of the launch, or -1
// for a shape or type the kernel does not take.
extern "C" int flash_attention_bwd_delta(
    const void* o, const void* dout, void* delta, int B, int Hq, int Sq,
    int D, int dtype, long long o_b, long long o_s, long long o_h,
    long long do_b, long long do_s, long long do_h, void* stream) {
  if (dtype != 1 || D % 64 != 0) return -1;
  const int rows = B * Hq * Sq;
  if (rows <= 0) return 0;
  delta_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows, Hq, Sq, D, o_b, o_s, o_h, do_b, do_s,
      do_h);
  return (int)cudaGetLastError();
}

// Tiles [start, start+num_tiles) of the backward's flat tile space: dQ tiles
// (B*Hq) x n_qblocks first, then dK/dV tiles (B*Hq/G) x ceil(Sk/BK),
// numbered as `tile_of` says, written in place into dq [B,Sq,Hq,D] and dk, dv
// [B,Sk,Hk,D].  q, dout [B,Sq,Hq,D]; k, v [B,Sk,Hk,D]; lse, delta [B,Hq,Sq]
// f32 contiguous (lse in natural base, +inf for a row that sees no key).
// Masks as the forward's: qpos = Sk - Sq + row sees kpos if kpos < Sk,
// kpos <= qpos (causal) and kpos > qpos - window (window > 0).  Strides in
// elements, last stride 1.  Returns the CUDA error of the launch (0 =
// success), -1 for a shape or type the kernel does not take (bfloat16 at
// head_dim 64 or 128 only), or -2 if a tensor map cannot be encoded.
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
  if (dtype != 1 || (D != 64 && D != 128)) return -1;
  if (num_tiles <= 0) return 0;
  const int Hk = Hq / G;
  Maps m;
  const int box_rows[2] = {BR, BS};
  for (int rows : box_rows) {
    const bool r = rows == BR;
    if (int e = encode_operand(r ? &m.q_res : &m.q_str, q, B, Sq, Hq, D, q_b,
                               q_s, q_h, rows)) return e;
    if (int e = encode_operand(r ? &m.do_res : &m.do_str, dout, B, Sq, Hq, D,
                               do_b, do_s, do_h, rows)) return e;
    if (int e = encode_operand(r ? &m.k_res : &m.k_str, k, B, Sk, Hk, D, k_b,
                               k_s, k_h, rows)) return e;
    if (int e = encode_operand(r ? &m.v_res : &m.v_str, v, B, Sk, Hk, D, v_b,
                               v_s, v_h, rows)) return e;
  }
  Args a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
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
  return D == 64 ? launch<64>(m, a, num_tiles, s)
                 : launch<128>(m, a, num_tiles, s);
}
