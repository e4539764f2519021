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
// Two more paths take what this design cannot hold, each a plain kernel of
// 256 threads over the same two-part tile space and the same masks, lse
// guard and ownership (one CTA an output tile, no atomics), with its own
// tile sizes (`flash_attention_bwd_block_q/_k(dtype, D)`):
//   * bfloat16 at head_dim 256 (`bwd_mma_kernel`): a thread of the design
//     above would hold dK and dV for 64 keys x 256 columns (256 f32
//     registers, over the 255 limit), and the resident pair alone is 128 KB.
//     Here dQ tiles are 128 query rows (8 warps of 16, dQ 128 registers a
//     thread, S and dP 32 keys at a time) and dK/dV tiles 64 keys, split by
//     role: warps 0-3 own dV, warps 4-7 dK, each 16 keys x 256.  The dV warps
//     compute S^T and P, the dK warps dP^T; P crosses to the dK warps through
//     shared memory in fragment order, one __syncthreads a 16-query chunk,
//     so the pair still issues seven products.  mma.sync m16n8k16 with
//     ldmatrix fragments (tensor_core.cuh), tiles staged by cp.async into
//     rows padded by 16 bytes, one buffer each (a block waits for its loads);
//   * float32 at head_dim 64, 128 and 256 (`bwd_f32_kernel`): full f32
//     products on the CUDA cores (wgmma and mma.sync have no f32 mode, and
//     TF32 would round the inputs), as the forward's f32 path: tiles of 64
//     rows resident in shared memory, streamed blocks of 32 rows, a thread
//     owning 4 x 2 scores and 4 rows x D/16 columns of each accumulator; P
//     and dS go through shared memory for the second products.  P is
//     exp(S*scale - lse) with expf, the outputs are f32.
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
  static constexpr int RES_TX = 2 * RES;        // bytes of the resident pair
  static constexpr int STR_TX = 2 * STR;        // bytes of a streamed pair
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

// ---------------------------------------------------------------------------
// The plain paths: bfloat16 at head_dim 256 and float32, tiles staged by
// cp.async from the model's layout (no tensor maps)
// ---------------------------------------------------------------------------

constexpr int PTHREADS = 256;   // 8 warps
constexpr int MQ = 128;         // bf16 head_dim 256: query rows of a dQ tile
constexpr int MK = 64;          // ... keys of a dK/dV tile, rows of a block
constexpr int QC = 16;          // ... query columns of a dK/dV chunk
constexpr int FT = 64;          // f32: rows of either tile
constexpr int FS = 32;          // f32: rows of a streamed block

struct In {   // the inputs' base pointers and strides, in elements
  const void *q, *k, *v, *dout;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h;
};

// rows [row0, row0 + ROWS) of a [*, D] operand of T -> shared rows of PITCH
// elements, zero-filled at or past `limit`; the caller commits and waits
template <typename T, int D, int ROWS, int PITCH>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int E = 16 / (int)sizeof(T);   // elements of a 16-byte chunk
  constexpr int CH = D / E;                // chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += PTHREADS) {
    const int r = i / CH, c = (i % CH) * E;
    const bool ok = row0 + r < limit;
    const T* s = ok ? src + (long long)(row0 + r) * row_stride + c : src;
    cp_async_16(dst + r * PITCH + c, s, ok);
  }
}

template <typename T>
__device__ __forceinline__ const T* head_base(const void* p, long long sb,
                                              long long sh, int b, int h) {
  return static_cast<const T*>(p) + b * sb + h * sh;
}

// --- bfloat16, head_dim 256: mma.sync --------------------------------------

constexpr int MP = 256 + 8;   // a padded bf16 row: ldmatrix free of conflicts

// A fragment (16 x 16) at (r0, c0) of a padded tile
__device__ __forceinline__ void load_a(unsigned (&r)[4], const bf16* t, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(r, t + (r0 + (lane & 15)) * MP + c0 + (lane >> 4) * 8);
}

// B fragments of n-tiles n0, n0 + 8 x 16 k from a tile stored [n][k]
__device__ __forceinline__ void load_b_nk(unsigned (&r)[4], const bf16* t,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(r, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * MP + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of n-tiles n0, n0 + 8 x 16 k from a tile stored [k][n]
__device__ __forceinline__ void load_b_kn(unsigned (&r)[4], const bf16* t,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * MP +
                           n0 + (lane >> 4) * 8);
}

// two neighbouring 16 x 8 f32 accumulator tiles as one bf16 A fragment
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[16 x 256] += a[16 x 16] * rows [k0, k0 + 16) of a tile stored [k][n]
__device__ __forceinline__ void mma_rows(float (&acc)[32][4],
                                         const unsigned (&a)[4], const bf16* t,
                                         int k0, int lane) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    unsigned b[4];
    load_b_kn(b, t, k0, n * 16, lane);
    mma_bf16(acc[2 * n], a, b[0], b[1]);
    mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// s[16 x 8N] = rows [r0, r0 + 16) of A times rows [n0, n0 + 8N) of B, both
// stored [row][d] over d < 256
template <int N>
__device__ __forceinline__ void mma_scores(float (&s)[N][4], const bf16* A,
                                           int r0, const bf16* B, int n0,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < 16; ++ks) {
    unsigned af[4];
    load_a(af, A, r0, ks * 16, lane);
#pragma unroll
    for (int n = 0; n < N / 2; ++n) {
      unsigned bf[4];
      load_b_nk(bf, B, n0 + n * 16, ks * 16, lane);
      mma_bf16(s[2 * n], af, bf[0], bf[1]);
      mma_bf16(s[2 * n + 1], af, bf[2], bf[3]);
    }
  }
}

// a warp's 16 rows of a [16 x 256] accumulator, times `mul`, as bf16 pairs;
// rows at or past `limit` are not stored
__device__ __forceinline__ void store_frag_rows(bf16* base, long long stride,
                                                int row0, int limit,
                                                const float (&acc)[32][4],
                                                float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < limit) {
      bf16* p = base + (long long)row * stride + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < 32; ++dt)
        *reinterpret_cast<unsigned*>(p + dt * 8) =
            pack_bf16(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

// P of a dK/dV chunk in fragment order: [2 buffers][4 warps][32 lanes][8]
constexpr int MMA_P = 2 * 4 * 32 * 8;
constexpr int MMA_SMEM =   // the larger role: a dQ tile's Q, dO, K, V
    (2 * MQ + 2 * MK) * MP * (int)sizeof(bf16);
static_assert(4 * MK * MP * 2 + (MMA_P + 2 * MK) * 4 <= MMA_SMEM,
              "a dK/dV tile fits in a dQ tile's room");
static_assert(MMA_SMEM <= 232448, "227 KB of shared memory a block");

// dQ of 128 query rows of one head: warp w owns rows r0 + 16 w; each 64-key
// block is taken 32 keys at a time
__device__ void dq_mma(const Args& a, const In& in, const Tile& tl,
                       const Range& rg, bf16* sm) {
  bf16* sQ = sm;
  bf16* sO = sQ + MQ * MP;
  bf16* sK = sO + MQ * MP;
  bf16* sV = sK + MK * MP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, off = a.Sk - a.Sq;
  const int hk = tl.h / a.G;
  load_rows<bf16, 256, MQ, MP>(
      sQ, head_base<bf16>(in.q, in.q_b, in.q_h, tl.b, tl.h), in.q_s, tl.r0,
      a.Sq);
  load_rows<bf16, 256, MQ, MP>(
      sO, head_base<bf16>(in.dout, in.do_b, in.do_h, tl.b, tl.h), in.do_s,
      tl.r0, a.Sq);
  cp_async_commit();
  const long long bh = (long long)tl.b * a.Hq + tl.h;
  const int qw = tl.r0 + warp * 16;   // the warp's first row
  float lse2[2], dlt[2];   // rows g and g + 8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const bool in_ = row < a.Sq;
    lse2[r] = in_ ? a.lse[bh * a.Sq + row] * LOG2E : INFINITY;
    dlt[r] = in_ ? a.delta[bh * a.Sq + row] : 0.f;
  }
  float acc[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const bf16* kb = head_base<bf16>(in.k, in.k_b, in.k_h, tl.b, hk);
  const bf16* vb = head_base<bf16>(in.v, in.v_b, in.v_h, tl.b, hk);
  for (int i = 0; i < rg.n; ++i) {
    const int k0 = (rg.blk0 + i) * MK;
    __syncthreads();   // the previous block's K, V are no longer read
    load_rows<bf16, 256, MK, MP>(sK, kb, in.k_s, k0, a.Sk);
    load_rows<bf16, 256, MK, MP>(sV, vb, in.v_s, k0, a.Sk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kc = 0; kc < MK; kc += 32) {
      float s[4][4], dp[4][4];
      mma_scores<4>(s, sQ, warp * 16, sK, kc, lane);
      mma_scores<4>(dp, sO, warp * 16, sV, kc, lane);
      // dS = P (dP - delta), P from the saved lse and zero where masked
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, row = qw + g + 8 * r;
          const int kpos = k0 + kc + nt * 8 + 2 * tq + (e & 1);
          const bool ok = row < a.Sq &&
                          visible(kpos, off + row, a.Sk, a.causal, a.window);
          const float p =
              ok ? exp2f(s[nt][e] * a.scale_log2e - lse2[r]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - dlt[r]);
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {   // dQ += dS K
        unsigned af[4];
        c_to_a(af, s[2 * kk], s[2 * kk + 1]);
        mma_rows(acc, af, sK, kc + kk * 16, lane);
      }
    }
  }
  cp_async_wait<0>();   // a tile with no visible key never waited
  store_frag_rows(static_cast<bf16*>(a.dq) + tl.b * a.dq_b + tl.h * a.dq_h,
                  a.dq_s, qw, a.Sq, acc, a.scale, lane);
}

// dK and dV of 64 keys of one KV head: warps 0-3 own dV of keys r0 + 16 w,
// warps 4-7 dK of keys r0 + 16 (w - 4).  Each 16-query chunk: the dV warps
// take S^T and P and pass P (in fragment order) to the dK warps, which take
// dP^T; after one barrier the dV warps add P^T dO, the dK warps dS^T Q.
__device__ void dkv_mma(const Args& a, const In& in, const Tile& tl,
                        const Range& rg, bf16* sm) {
  bf16* sK = sm;
  bf16* sV = sK + MK * MP;
  bf16* sQ = sV + MK * MP;
  bf16* sO = sQ + MK * MP;
  float* sP = reinterpret_cast<float*>(sO + MK * MP);
  float* sL = sP + MMA_P;   // lse * log2 e of the block's rows
  float* sD = sL + MK;      // their delta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, off = a.Sk - a.Sq;
  const bool dv_role = warp < 4;
  const int kw = tl.r0 + (warp & 3) * 16;   // the warp's first key
  load_rows<bf16, 256, MK, MP>(
      sK, head_base<bf16>(in.k, in.k_b, in.k_h, tl.b, tl.h), in.k_s, tl.r0,
      a.Sk);
  load_rows<bf16, 256, MK, MP>(
      sV, head_base<bf16>(in.v, in.v_b, in.v_h, tl.b, tl.h), in.v_s, tl.r0,
      a.Sk);
  cp_async_commit();
  float acc[32][4];   // dV (dv_role) or dK
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int i = 0; i < rg.n; ++i) {
    const int head = tl.h * a.G + i / rg.nq;
    const int q0 = (rg.blk0 + i % rg.nq) * MK;
    const long long bh = (long long)tl.b * a.Hq + head;
    __syncthreads();   // the previous block's Q, dO, P, lse, delta are read
    load_rows<bf16, 256, MK, MP>(
        sQ, head_base<bf16>(in.q, in.q_b, in.q_h, tl.b, head), in.q_s, q0,
        a.Sq);
    load_rows<bf16, 256, MK, MP>(
        sO, head_base<bf16>(in.dout, in.do_b, in.do_h, tl.b, head), in.do_s,
        q0, a.Sq);
    cp_async_commit();
    if (threadIdx.x < MK) {
      const int row = q0 + threadIdx.x;
      const bool in_ = row < a.Sq;
      sL[threadIdx.x] = in_ ? a.lse[bh * a.Sq + row] * LOG2E : INFINITY;
      sD[threadIdx.x] = in_ ? a.delta[bh * a.Sq + row] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < MK; c0 += QC) {
      float* slot = sP + ((((c0 / QC) & 1) * 4 + (warp & 3)) * 32 + lane) * 8;
      float st[2][4];   // S^T (dV warps) or dP^T (dK warps): 16 keys x QC
      mma_scores<2>(st, dv_role ? sK : sV, (warp & 3) * 16,
                    dv_role ? sQ : sO, c0, lane);
      if (dv_role) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + nt * 8 + 2 * tq + (e & 1), row = q0 + col;
            const bool ok = row < a.Sq && visible(kw + g + 8 * (e >> 1),
                                                  off + row, a.Sk, a.causal,
                                                  a.window);
            st[nt][e] = ok ? exp2f(st[nt][e] * a.scale_log2e - sL[col]) : 0.f;
          }
        reinterpret_cast<float4*>(slot)[0] =
            make_float4(st[0][0], st[0][1], st[0][2], st[0][3]);
        reinterpret_cast<float4*>(slot)[1] =
            make_float4(st[1][0], st[1][1], st[1][2], st[1][3]);
      }
      __syncthreads();   // this chunk's P is in shared memory
      if (!dv_role) {    // dS^T = P^T (dP^T - delta)
        const float4 p0 = reinterpret_cast<const float4*>(slot)[0];
        const float4 p1 = reinterpret_cast<const float4*>(slot)[1];
        const float p[2][4] = {{p0.x, p0.y, p0.z, p0.w},
                               {p1.x, p1.y, p1.z, p1.w}};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[nt][e] = p[nt][e] *
                        (st[nt][e] - sD[c0 + nt * 8 + 2 * tq + (e & 1)]);
      }
      // dV += P^T dO (dV warps), dK += dS^T Q (dK warps)
      unsigned af[4];
      c_to_a(af, st[0], st[1]);
      mma_rows(acc, af, dv_role ? sO : sQ, c0, lane);
    }
  }
  cp_async_wait<0>();   // a tile no query row sees never waited
  if (dv_role)
    store_frag_rows(static_cast<bf16*>(a.dv) + tl.b * a.dv_b + tl.h * a.dv_h,
                    a.dv_s, kw, a.Sk, acc, 1.f, lane);
  else
    store_frag_rows(static_cast<bf16*>(a.dk) + tl.b * a.dk_b + tl.h * a.dk_h,
                    a.dk_s, kw, a.Sk, acc, a.scale, lane);
}

__global__ void __launch_bounds__(PTHREADS, 1)
bwd_mma_kernel(const Args a, const In in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const Tile tl = tile_of<MQ, MK>(a, a.start + (int)blockIdx.x);
  const Range rg = range_of<MQ, MK, MK>(a, tl);
  if (tl.dq)
    dq_mma(a, in, tl, rg, sm);
  else
    dkv_mma(a, in, tl, rg, sm);
}

// --- float32: the CUDA cores ------------------------------------------------

constexpr int FPP = FS + 4;   // a padded row of the P / dS tiles

template <int D>
constexpr int f32_smem() {   // resident pair, streamed pair, P, dS, lse, delta
  return (int)sizeof(float) *
         ((2 * FT + 2 * FS) * (D + 4) + 2 * FT * FPP + 2 * FS);
}
static_assert(f32_smem<256>() <= 232448, "227 KB of shared memory a block");

// thread (ty, tx) of 16 x 16: s[i][j] = A row ty + 16 i . B row tx + 16 j
// over d < D (A: FT resident rows, B: FS streamed rows, both [row][D + 4])
template <int D>
__device__ __forceinline__ void f32_scores(float (&s)[4][2], const float* A,
                                           const float* B, int tx, int ty) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 bv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(A + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[i][j] += av.x * bv[j].x + av.y * bv[j].y + av.z * bv[j].z +
                   av.w * bv[j].w;
    }
  }
}

// acc[i][g][c] += sum_j C[ty + 16 i][j] * B[j][g * 64 + 4 tx + c] over the FS
// streamed rows j (C: [FT][FPP], B: [FS][D + 4])
template <int D>
__device__ __forceinline__ void f32_accumulate(float (&acc)[4][D / 64][4],
                                               const float* C, const float* B,
                                               int tx, int ty) {
  constexpr int DP = D + 4;
#pragma unroll 2
  for (int j = 0; j < FS; j += 4) {
    float c4[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 cv =
          *reinterpret_cast<const float4*>(C + (ty + 16 * i) * FPP + j);
      c4[i][0] = cv.x; c4[i][1] = cv.y; c4[i][2] = cv.z; c4[i][3] = cv.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 bv = *reinterpret_cast<const float4*>(
            B + (j + jj) * DP + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g][0] += c4[i][jj] * bv.x;
          acc[i][g][1] += c4[i][jj] * bv.y;
          acc[i][g][2] += c4[i][jj] * bv.z;
          acc[i][g][3] += c4[i][jj] * bv.w;
        }
      }
  }
}

template <int D>
__device__ __forceinline__ void f32_zero(float (&acc)[4][D / 64][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      acc[i][g][0] = acc[i][g][1] = acc[i][g][2] = acc[i][g][3] = 0.f;
}

// rows r0 + ty + 16 i (i < 4) of an accumulator, times `mul`, below `limit`,
// into out[b, row, h, :]
template <int D>
__device__ __forceinline__ void f32_store(void* out, long long sb,
                                          long long ss, long long sh, int b,
                                          int h, int r0, int limit,
                                          const float (&acc)[4][D / 64][4],
                                          float mul, int tx, int ty) {
  float* base = static_cast<float*>(out) + b * sb + h * sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row < limit) {
#pragma unroll
      for (int g = 0; g < D / 64; ++g)
        *reinterpret_cast<float4*>(base + row * ss + g * 64 + tx * 4) =
            make_float4(acc[i][g][0] * mul, acc[i][g][1] * mul,
                        acc[i][g][2] * mul, acc[i][g][3] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(PTHREADS, 1)
bwd_f32_kernel(const Args a, const In in) {
  constexpr int DP = D + 4, NG = D / 64;
  extern __shared__ __align__(16) float fsm[];
  float* sR0 = fsm;              // resident [FT][DP]: Q (dQ) or K (dK/dV)
  float* sR1 = sR0 + FT * DP;    // dO or V
  float* sS0 = sR1 + FT * DP;    // streamed [FS][DP]: K or Q
  float* sS1 = sS0 + FS * DP;    // V or dO
  float* sP = sS1 + FS * DP;     // [FT][FPP]: P^T (dK/dV tiles)
  float* sG = sP + FT * FPP;     // [FT][FPP]: dS or dS^T
  float* sL = sG + FT * FPP;     // [FS]: the streamed rows' lse
  float* sD = sL + FS;           // [FS]: their delta
  const Tile tl = tile_of<FT, FT>(a, a.start + (int)blockIdx.x);
  const Range rg = range_of<FT, FT, FS>(a, tl);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = a.Sk - a.Sq;
  float acc0[4][NG][4], acc1[4][NG][4];   // dQ or dK; dV
  f32_zero<D>(acc0);
  f32_zero<D>(acc1);
  if (tl.dq) {
    const int hk = tl.h / a.G;
    load_rows<float, D, FT, DP>(
        sR0, head_base<float>(in.q, in.q_b, in.q_h, tl.b, tl.h), in.q_s,
        tl.r0, a.Sq);
    load_rows<float, D, FT, DP>(
        sR1, head_base<float>(in.dout, in.do_b, in.do_h, tl.b, tl.h),
        in.do_s, tl.r0, a.Sq);
    cp_async_commit();
    const long long bh = (long long)tl.b * a.Hq + tl.h;
    float lse[4], dlt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tl.r0 + ty + 16 * i;
      lse[i] = row < a.Sq ? a.lse[bh * a.Sq + row] : INFINITY;
      dlt[i] = row < a.Sq ? a.delta[bh * a.Sq + row] : 0.f;
    }
    const float* kb = head_base<float>(in.k, in.k_b, in.k_h, tl.b, hk);
    const float* vb = head_base<float>(in.v, in.v_b, in.v_h, tl.b, hk);
    for (int it = 0; it < rg.n; ++it) {
      const int k0 = (rg.blk0 + it) * FS;
      __syncthreads();   // the previous block's K, V, dS are no longer read
      load_rows<float, D, FS, DP>(sS0, kb, in.k_s, k0, a.Sk);
      load_rows<float, D, FS, DP>(sS1, vb, in.v_s, k0, a.Sk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float s[4][2], dp[4][2];
      f32_scores<D>(s, sR0, sS0, tx, ty);
      f32_scores<D>(dp, sR1, sS1, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tl.r0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = row < a.Sq && visible(k0 + tx + 16 * j, off + row,
                                                a.Sk, a.causal, a.window);
          const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
          sG[(ty + 16 * i) * FPP + tx + 16 * j] = p * (dp[i][j] - dlt[i]);
        }
      }
      __syncthreads();
      f32_accumulate<D>(acc0, sG, sS0, tx, ty);   // dQ += dS K
    }
    cp_async_wait<0>();   // a tile with no visible key never waited
    f32_store<D>(a.dq, a.dq_b, a.dq_s, a.dq_h, tl.b, tl.h, tl.r0, a.Sq, acc0,
                 a.scale, tx, ty);
    return;
  }
  load_rows<float, D, FT, DP>(
      sR0, head_base<float>(in.k, in.k_b, in.k_h, tl.b, tl.h), in.k_s, tl.r0,
      a.Sk);
  load_rows<float, D, FT, DP>(
      sR1, head_base<float>(in.v, in.v_b, in.v_h, tl.b, tl.h), in.v_s, tl.r0,
      a.Sk);
  cp_async_commit();
  for (int it = 0; it < rg.n; ++it) {
    const int head = tl.h * a.G + it / rg.nq;
    const int q0 = (rg.blk0 + it % rg.nq) * FS;
    const long long bh = (long long)tl.b * a.Hq + head;
    __syncthreads();   // the previous block's Q, dO, P, dS are no longer read
    load_rows<float, D, FS, DP>(
        sS0, head_base<float>(in.q, in.q_b, in.q_h, tl.b, head), in.q_s, q0,
        a.Sq);
    load_rows<float, D, FS, DP>(
        sS1, head_base<float>(in.dout, in.do_b, in.do_h, tl.b, head),
        in.do_s, q0, a.Sq);
    cp_async_commit();
    if (threadIdx.x < FS) {
      const int row = q0 + threadIdx.x;
      sL[threadIdx.x] = row < a.Sq ? a.lse[bh * a.Sq + row] : INFINITY;
      sD[threadIdx.x] = row < a.Sq ? a.delta[bh * a.Sq + row] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float st[4][2], dpt[4][2];   // S^T, dP^T: keys x this block's queries
    f32_scores<D>(st, sR0, sS0, tx, ty);
    f32_scores<D>(dpt, sR1, sS1, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = tl.r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = tx + 16 * j, row = q0 + col;
        const bool ok = row < a.Sq &&
                        visible(key, off + row, a.Sk, a.causal, a.window);
        const float p = ok ? expf(st[i][j] * a.scale - sL[col]) : 0.f;
        sP[(ty + 16 * i) * FPP + col] = p;
        sG[(ty + 16 * i) * FPP + col] = p * (dpt[i][j] - sD[col]);
      }
    }
    __syncthreads();
    f32_accumulate<D>(acc1, sP, sS1, tx, ty);   // dV += P^T dO
    f32_accumulate<D>(acc0, sG, sS0, tx, ty);   // dK += dS^T Q
  }
  cp_async_wait<0>();   // a tile no query row sees never waited
  f32_store<D>(a.dk, a.dk_b, a.dk_s, a.dk_h, tl.b, tl.h, tl.r0, a.Sk, acc0,
               a.scale, tx, ty);
  f32_store<D>(a.dv, a.dv_b, a.dv_s, a.dv_h, tl.b, tl.h, tl.r0, a.Sk, acc1,
               1.f, tx, ty);
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

// the paths: 1 = bf16 wgmma (head_dim 64, 128), 2 = bf16 mma.sync (256),
// 3 = f32 (64, 128, 256); 0 = not taken
int path_of(int dtype, int D) {
  if (dtype == 1) return D == 64 || D == 128 ? 1 : D == 256 ? 2 : 0;
  if (dtype == 0) return D == 64 || D == 128 || D == 256 ? 3 : 0;
  return 0;
}

}  // namespace

// Query rows of a dQ tile and keys of a dK/dV tile of the path that takes
// (dtype, D), or -1 if none does; the wrapper sizes the tile space with them.
extern "C" int flash_attention_bwd_block_q(int dtype, int D) {
  const int p = path_of(dtype, D);
  return p == 1 ? BQ : p == 2 ? MQ : p == 3 ? FT : -1;
}
extern "C" int flash_attention_bwd_block_k(int dtype, int D) {
  const int p = path_of(dtype, D);
  return p == 1 ? BK : p == 2 ? MK : p == 3 ? FT : -1;
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
  if (path != 1) {
    const In in = {q, k, v, dout, q_b, q_s, q_h, k_b, k_s, k_h,
                   v_b, v_s, v_h, do_b, do_s, do_h};
    if (path == 2)
      return launch_with(bwd_mma_kernel, MMA_SMEM, num_tiles, PTHREADS, s, a,
                         in);
    return D == 64 ? launch_with(bwd_f32_kernel<64>, f32_smem<64>(),
                                 num_tiles, PTHREADS, s, a, in)
         : D == 128 ? launch_with(bwd_f32_kernel<128>, f32_smem<128>(),
                                  num_tiles, PTHREADS, s, a, in)
                    : launch_with(bwd_f32_kernel<256>, f32_smem<256>(),
                                  num_tiles, PTHREADS, s, a, in);
  }
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
  return D == 64 ? launch_with(flash_attn_bwd_kernel<64>, Smem<64>::BYTES,
                               num_tiles, NTHREADS, s, m, a)
                 : launch_with(flash_attn_bwd_kernel<128>, Smem<128>::BYTES,
                               num_tiles, NTHREADS, s, m, a);
}
